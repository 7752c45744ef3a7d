"""Foundations: cell configuration, Gold sequences, CRC, bit helpers,
device selection and the CUDA kernel builder."""

from .cell import CP, Cell, SF_RE_LEN, sf_sample_len, symbol_sz
from .sequence import gold_sequence, gold_state
from .crc import Crc, CRC24A, CRC24B, CRC16, CRC8
from .device import resolve_device
from . import bits

__all__ = [
    "CP",
    "Cell",
    "SF_RE_LEN",
    "sf_sample_len",
    "symbol_sz",
    "gold_sequence",
    "gold_state",
    "Crc",
    "CRC24A",
    "CRC24B",
    "CRC16",
    "CRC8",
    "resolve_device",
    "bits",
]
