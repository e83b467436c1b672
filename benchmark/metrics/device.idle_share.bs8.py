"""Share of the traced slice of the cell's loop (batch 8) in which no
operation ran on the device."""


def read(run):
    if run.trace is None or run.batch != 8:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
