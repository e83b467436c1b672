"""Build and load the port's hand-written CUDA kernels.

Each of `openpose_plus_tpu_torch/csrc/*.cu` compiles with its own `nvcc`
process, all started together, and one more `nvcc` links the objects into
one shared library with a plain C interface, loaded with ctypes (no PyTorch
headers: a build takes seconds, not minutes). The library lands in
`openpose_plus_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
flags, at first use in a process; nothing is built at import time.

Each C entry point takes raw device pointers, sizes, the device index and
the CUDA stream, launches on that stream without synchronising, and returns
`cudaGetLastError()`; the Python wrappers raise when it is not 0.
`--use_fast_math` is never passed: the merge kernel's float additions must
keep their association, and the separable conv's bf16 roundings their
place.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (name, argtypes). Every entry returns a cudaError_t as int.
_SIGNATURES = {
    # scores, batch, n_limbs, k, slot_a, slot_b, score, valid, device, stream
    "greedy_assign_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # slot_a, slot_b, score, valid, peak_score, pairs, batch, n_limbs,
    # n_parts, k, max_humans, n_create, parts, subset_score, count, device,
    # stream
    "assemble_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _I, _P],
    # x, dw_kernel, dw_bias, pw_kernel, pw_bias, y, batch, h, w, c, f,
    # device, stream
    "fused_sepconv_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P],
    # x, dw_kernel, y, batch, h, w, c, device, stream (both probe bodies)
    "dw3x3_relu_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "copy_bias_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # paf, sy, sx, chans, px, py, batch, h, w, c, n_limbs, n, device, stream
    "sample_paf_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    # q, w, rescale, bias, s_out, y, batch, h, w, cin, cout, ho, wo,
    # kernel, stride, pad_top, pad_left, block_m, block_n, device, stream
    "int8_conv_launch": [_P] * 6 + [_I] * 14 + [_P],
    # x, scale, out, rows, c, cp, device, stream
    "quantize_act_launch": [_P, _P, _P] + [ctypes.c_longlong] * 3
                           + [_I, _P],
    # maps, its four strides, batch, h, w, n_parts, threshold, k, keys, cap,
    # counts, y, x, score, valid, ry, rx, device, stream
    "find_peaks_launch": [_P] + [ctypes.c_longlong] * 4 + [_I] * 4
                         + [ctypes.c_float, _I, _P, _I] + [_P] * 7
                         + [_I, _P],
    # y, bias, slope, out, wide, pixels, c, wide_c, offset, h, w, pool,
    # dtype, device, stream
    "bias_act_launch": [_P] * 5 + [ctypes.c_longlong] + [_I] * 8 + [_P],
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def sources() -> list[Path]:
    """The sources nvcc compiles, one object each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (`csrc/*.cuh`)."""
    return sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    """The build's key: the flags, and every source's and header's name and
    bytes (an edited header rebuilds the library)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources() + headers()):
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
    tag = f".tmp-{os.getpid()}"
    nvcc = _nvcc()
    objs = [out_dir / f"{src.stem}{tag}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    tmp = out_dir / f"{tag}.so"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    (out_dir / "nvcc.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
