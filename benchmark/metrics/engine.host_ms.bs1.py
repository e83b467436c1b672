"""Mean host ms of the program's `engine.infer` span (the call inside the
program: inputs, copy in, launch, copies of the outputs) in a 1 s slice of
the cell's loop at batch 1 recorded by the program's tracer
(`spans.host_slice`); None if the slice saw a call run eagerly."""

from harness import spans


def read(run):
    if run.batch != 1:
        return None
    rec = spans.host_slice(run)
    if rec is None or rec.counters.get("engine.eager_calls"):
        return None
    return rec.mean_ms("engine.infer")
