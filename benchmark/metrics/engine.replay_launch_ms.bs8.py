"""Mean host ms of the program's `engine.replay` span (`graph.replay()`, the
CUDA graph's launch) in a 1 s slice of the cell's loop at batch 8 recorded
by the program's tracer (`spans.host_slice`); None without a replay."""

from harness import spans


def read(run):
    if run.batch != 8:
        return None
    rec = spans.host_slice(run)
    return None if rec is None else rec.mean_ms("engine.replay")
