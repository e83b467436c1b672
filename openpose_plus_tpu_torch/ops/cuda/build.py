"""Build and load the port's hand-written CUDA kernels.

All of `openpose_plus_tpu_torch/csrc/*.cu` compile with one `nvcc` call into
one shared library with a plain C interface, loaded with ctypes (no PyTorch
headers: a build takes seconds, not minutes). The library lands in
`openpose_plus_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
flags, at first use in a process; nothing is built at import time.

Each C entry point takes raw device pointers, sizes, the device index and
the CUDA stream, launches on that stream without synchronising, and returns
`cudaGetLastError()`; the Python wrappers raise when it is not 0.
`--use_fast_math` is never passed: the merge kernel's float additions must
keep their association.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (name, argtypes). Every entry returns a cudaError_t as int.
_SIGNATURES = {
    # scores, batch, k, slot_a, slot_b, score, valid, device, stream
    "greedy_assign_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _P],
    # slot_a, slot_b, score, valid, peak_score, pairs, batch, n_limbs, k,
    # max_humans, n_create, parts, subset_score, count, device, stream
    "assemble_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P, _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "port's CUDA kernels are built on the GPU machine")


def build() -> Path:
    """Compile the kernels (once per source hash); returns the .so path.
    nvcc's output, with ptxas' register and shared-memory report, is kept
    beside the library as nvcc.log."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libopenpose_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".tmp-{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [_I]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        text = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text}) at launch")
