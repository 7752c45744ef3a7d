"""A frozen copy of the port's encoders, from which the benchmark's
transmitters (``phybench.inputs``) are built.

The modules are the port's ``utils``, ``ops`` and ``models`` files that
the 20 MHz TM4 downlink's and the PUSCH with UCI's transmit chains need,
copied as they stood when the benchmark was written, with their relative
imports intact and the receive side taken out (each module's docstring
is the port's as copied, receive side and all). One change of substance:
the uplink DMRS (``models/refsignal_ul.py``) has the n_PN(ns) term of TS
36.211 5.5.2.1.1 that the port's leaves out. Nothing here imports the
port, so later changes to the port do not move the inputs; and the plain
receivers in ``phybench.references`` import nothing from here.
"""
