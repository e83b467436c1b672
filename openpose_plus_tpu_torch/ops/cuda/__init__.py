"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version; sources in `openpose_plus_tpu_torch/csrc/`, built at first
use by `build.py`. Importing this package builds and loads nothing."""
