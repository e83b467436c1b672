"""Device ms of the program's `models.paf_stages` span (BODY_25's
four PAF stages) in one forward of the cell at batch 8, from the
program's own device span (`forward_spans.forward_stages`: CUDA events in
a captured graph of 20 forwards); None where the program has no such
span."""

from harness import forward_spans


def read(run):
    if run.batch != 8:
        return None
    stages = forward_spans.forward_stages(run)
    return None if stages is None else stages.get("models.paf_stages")
