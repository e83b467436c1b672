"""Device ms of the program's `postproc.group` stage (PAF scores,
greedy assignment, merge, lookup, compaction) in one decode of the cell
at batch 8, from the program's own device span (`spans.decode_stages`:
CUDA events in a captured graph of 20 decodes)."""

from harness import spans


def read(run):
    if run.batch != 8:
        return None
    stages = spans.decode_stages(run)
    return None if stages is None else stages.get("postproc.group")
