"""Seconds from the start of the process to the first timed call: weights
and inputs made from the seed, the kernels built or loaded, the engine
compiled and every shape the cell uses warmed."""


def read(run):
    return run.setup_s
