"""Foundations: cell configuration, Gold sequences, CRC and bit helpers,
and the cache of tables on the device."""
