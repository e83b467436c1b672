"""Device ms of the program's forward (`Engine.forward`) at batch 8 on one
of the cell's inputs, by CUDA-graph replay."""


def read(run):
    return run.forward_device_ms() if run.batch == 8 else None
