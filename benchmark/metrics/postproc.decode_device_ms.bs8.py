"""Device ms of the program's decode (`postproc.decode_maps`, the cell's
decode settings) at batch 8 on the forward's maps of one of the cell's
inputs, by CUDA-graph replay."""


def read(run):
    return run.decode_device_ms() if run.batch == 8 else None
