"""mbps: the bits of every transport block of the window whose CRC
passed and whose bits equal the sent ones, over the window's wall time
(host clock, from the first call's start to the last call's results on
the host), in Mbit/s."""


def read(win) -> float:
    return win.totals["bits"] / win.wall_s / 1e6
