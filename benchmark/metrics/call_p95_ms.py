"""The 95th percentile of every call's time in the window, from the frame
handed to the host to its people on the host, in ms."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
