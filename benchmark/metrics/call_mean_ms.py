"""The mean time of a call over the window, in ms: the window's length
over the calls it completed (one caller, closed loop, each call from the
frame handed to the host to its people on the host)."""


def read(run):
    return 1e3 * run.window_s / run.calls if run.calls else None
