"""The PAF family on the program's side: the port's `decode_maps` on the
last stage's (conf, paf)."""

from __future__ import annotations


def decode_call(run):
    from openpose_plus_tpu_torch.postproc import decode_maps

    conf, paf = run.engine.forward(run.driver.model_batch())
    cfg = run.engine.config.postproc
    return lambda: decode_maps(conf, paf, cfg)
