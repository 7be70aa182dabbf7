"""Build, load and call the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds). The library is built at first
use into ``build/torch_kernels/`` beside the package, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Each C entry launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.

Nothing here runs at import: this module is imported on machines without
``nvcc`` or a GPU, where only the plain twins in ``ops/`` are used.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["load_library", "launch", "check_cuda", "stream_of", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argument types (pointers and the stream as void*, ints as int)
_SIGNATURES = {
    # q, k, v, pos, bias_u, bias_v, lengths, out, B, T, H, dh, stream
    "rs_relpos_attention_fused": [_P] * 8 + [_I] * 4 + [_P],
    # x, w_in, b_in, dw, b_dw, bn_scale, bn_bias, w_out, b_out, lengths,
    # glu scratch, swish scratch, out, B, T, D, K, stream
    "rs_fused_conv_module": [_P] * 13 + [_I] * 4 + [_P],
    # logits, lp_blank, top_lp, top_tok, R, V, m, blank, is_bf16, stream
    "rs_topm_logsoftmax": [_P] * 4 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
_info = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(cu, cuh):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build():
    cu, cuh = _sources()
    so = BUILD_DIR / f"librs_torch_kernels_{_digest(cu, cuh)}.so"
    if so.exists():
        _info.update(path=str(so), seconds=0.0, log="(cached)")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    _info.update(path=str(so), seconds=seconds, log=proc.stderr)
    return so


def load_library():
    """The kernels' shared library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rs_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rs_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build_info():
    """{path, seconds, log} of the library this process loaded (after
    :func:`load_library`); ``log`` holds ptxas' register/smem report."""
    return dict(_info)


def launch(name, *args):
    """Call C entry ``name``; raise if the launch reported a CUDA error."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.rs_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name, t, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (and ``shape``/``device`` when given)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
