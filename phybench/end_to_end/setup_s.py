"""setup_s: seconds from the process's start to the window's: imports,
the card, the inputs drawn on the card, the port's plans and kernel
builds (the first run in a checkout compiles them) and the warm-up
calls."""


def read(win) -> float:
    return win.setup_s
