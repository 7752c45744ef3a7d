"""DSP ops: OFDM, modem, scrambling, channel estimation, MIMO, FEC."""
