"""Images whose people reached the host in the window, a second."""


def read(run):
    return run.images / run.window_s
