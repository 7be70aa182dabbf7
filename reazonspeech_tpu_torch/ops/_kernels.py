"""Build, load and call the port's CUDA kernels.

The ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a``, one
process per source, all started together, and link into ONE shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library is built at first
use into ``build/torch_kernels/`` beside the package (:data:`BUILD_DIR`;
``utils.enable_compile_cache`` moves it), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Each C entry launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0,
and otherwise adds one to the counter ``launch.<kernel>`` of
``utils.profiling`` (the kernel's name is the entry without its ``rs_``
prefix), or, inside :func:`deferred_launches` (a CUDA graph's capture,
whose kernels run only when it is replayed), to the block's own tally.

Nothing here runs at import: this module is imported on machines without
``nvcc`` or a GPU, where only the plain twins in ``ops/`` are used.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils.profiling import count

__all__ = ["KERNELS", "as_dtype", "build_info", "check_cuda", "deferred_launches",
           "forced_tile_n", "launch", "launch_on", "load_library", "records", "refuse_grad",
           "stream_of", "workspace_words"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (pointers and the stream as void*, ints as int)
_SIGNATURES = {
    # q, k, v, pos, bias_u, bias_v, lengths, out, B, T, H, dh, stream
    "rs_relpos_attention_fused": [_P] * 8 + [_I] * 4 + [_P],
    # qkv, pos, bias_u, bias_v, lengths, out, B, T, H, dh, stream
    "rs_relpos_attention_fused_packed": [_P] * 6 + [_I] * 4 + [_P],
    # qu, qv, k, v, pos, lengths, out, B, T, H, dh, stream
    "rs_relpos_attention": [_P] * 7 + [_I] * 4 + [_P],
    "rs_relpos_attention_blockwise": [_P] * 7 + [_I] * 4 + [_P],
    # x, w_in, b_in, dw, b_dw, bn_scale, bn_bias, w_out, b_out, lengths,
    # glu scratch, swish scratch, out, B, T, D, K, stream
    "rs_fused_conv_module": [_P] * 13 + [_I] * 4 + [_P],
    # x_raw, ln_g, ln_b, w_in, b_in, dw, b_dw, bn_scale, bn_bias, w_out, b_out,
    # lengths, LN scratch, glu scratch, swish scratch, out, B, T, D, K, stream
    "rs_fused_conv_module_ln": [_P] * 16 + [_I] * 4 + [_P],
    # the two forms again with the per-frame LayerNorm's affine in place of
    # the folded batch norm
    "rs_fused_conv_module_layer": [_P] * 13 + [_I] * 4 + [_P],
    "rs_fused_conv_module_ln_layer": [_P] * 16 + [_I] * 4 + [_P],
    # x, g, b, w0, w1, w2, c0, c1, c2, n0, n1, n2, LN scratch, out, M, D,
    # swish, eps, stream
    "rs_ln_dense": [_P] * 9 + [_I] * 3 + [_P] * 2 + [_I] * 3 + [_F, _P],
    # r, delta, g, b, w0, w1, w2, c0, c1, c2, n0, n1, n2, LN scratch,
    # summed-stream out, out, M, D, swish, scale, eps, stream
    "rs_ln_dense_add": [_P] * 10 + [_I] * 3 + [_P] * 3 + [_I] * 3 + [_F, _F, _P],
    # r, y, g, b, lengths, out, B, T, D, scale, eps, stream
    "rs_add_ln": [_P] * 6 + [_I] * 3 + [_F, _F, _P],
    # logits, lp_blank, top_lp, top_tok, scratch, tickets, R, V, m, blank,
    # is_bf16, stream
    "rs_topm_logsoftmax": [_P] * 6 + [_I] * 5 + [_P],
    # q, k, qp, pos, v, lengths, out, G, T, qd, pd, dv, heads, scale, stream
    "rs_shared_rel_attention": [_P] * 7 + [_I] * 6 + [_F, _P],
    "rs_shared_rel_attention_blockwise": [_P] * 7 + [_I] * 6 + [_F, _P],
    # w_pred, b_pred, w_out, b_out, enc, dec, scratch, tickets, lp_blank,
    # top_lp, top_tok, R, H, J, V, m, blank, activation, stream
    "rs_joint_topm": [_P] * 11 + [_I] * 7 + [_P],
    # x, h, c, w_ih, w_hh, bias, h_out, c_out, R, H_in, H, stream
    "rs_lstm_cell_step": [_P] * 8 + [_I] * 3 + [_P],
}
KERNELS = tuple(name.removeprefix("rs_") for name in _SIGNATURES)
# C function -> the sizes it takes: the workspace a kernel's call needs,
# which the kernel sizes since it decides how it splits its work
_WORKSPACES = {
    "rs_topm_workspace": [_I] * 3,  # R, V, m
    "rs_joint_workspace": [_I] * 4,  # R, J, V, m
}
_lock = threading.Lock()
_lib = None
_info = {}
_local = threading.local()  # .tally: the calling thread's deferred launches


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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        logs = [Path(tmp) / f"{src.stem}.log" for src in cu]
        procs = []
        for src, obj, log in zip(cu, objs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT))
        codes = [proc.wait() for proc in procs]
        log = "".join(path.read_text() for path in logs)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
        linked = Path(tmp) / so.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(linked), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(linked, so)  # atomic: a concurrent build never sees a partial file
    _info.update(path=str(so), seconds=time.perf_counter() - t0, log=log)
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
            lib.rs_gemm_force_tile_n.argtypes = [ctypes.c_int]
            lib.rs_gemm_force_tile_n.restype = ctypes.c_int
            for name, argtypes in _WORKSPACES.items():
                getattr(lib, name).argtypes = argtypes + [ctypes.POINTER(ctypes.c_int)]
                getattr(lib, name).restype = ctypes.c_longlong
            _lib = lib
    return _lib


def build_info():
    """{path, seconds, log} of the library this process loaded (after
    :func:`load_library`); ``log`` holds ptxas' register/smem report."""
    return dict(_info)


def launch(name, *args):
    """Call C entry ``name``; raise if the launch reported a CUDA error,
    else count the launch."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.rs_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    key = "launch." + name.removeprefix("rs_")
    tally = getattr(_local, "tally", None)
    if tally is None:
        count(key)  # mesh entries launch from threads of their own
    else:
        tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def deferred_launches():
    """Within the block, the calling thread's launches are tallied into the
    yielded ``{counter name: launches}`` instead of the store's counters: a
    CUDA graph's capture records kernels that run only when it is replayed,
    and each replay adds the tally (``utils.profiling.count``)."""
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        del _local.tally


def launch_on(dev, name, *args):
    """launch() on ``dev``: a kernel goes to the calling thread's current
    device, so switch to ``dev`` only where it is not that one."""
    if dev.index == torch.cuda.current_device():
        launch(name, *args)
    else:
        with torch.cuda.device(dev):
            launch(name, *args)


@functools.lru_cache(maxsize=None)
def workspace_words(kernel, *sizes):
    """(counters, 32-bit words of scratch) that a call of ``kernel`` ("topm"
    or "joint") with these sizes needs, as its C code splits the work."""
    counters = ctypes.c_int(0)
    words = getattr(load_library(), f"rs_{kernel}_workspace")(*sizes, ctypes.byref(counters))
    return counters.value, words


@contextlib.contextmanager
def forced_tile_n(tile_n):
    """Within the block, every GEMM (``ln_dense`` and the conv module's two
    products) launches with its column tile forced to ``tile_n`` (128 or
    256; 0: chosen per shape, the default); for tests and timing only."""
    fn = load_library().rs_gemm_force_tile_n
    prev = fn(tile_n)
    try:
        yield
    finally:
        fn(prev)


def records(*tensors):
    """True when autograd records an op on these inputs: grad mode is on and
    one of them (``None`` and non-tensors skipped) requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(kernel, *tensors, hint=None):
    """Raise NotImplementedError when autograd records on ``tensors``: a
    kernel launched through ctypes returns a tensor with no ``grad_fn``, so
    its gradients would be silently zero. ``hint`` names what to call
    instead."""
    if records(*tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward"
            + (f"; {hint}" if hint else " (the JAX kernel has no VJP either)"))


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def as_dtype(dtype):
    """A torch dtype from its name ("float32") or itself."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def check_cuda(name, t, dtype, shape=None, device=None, aligned=True):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``/``device`` when given), 16-byte aligned unless ``aligned`` is
    false."""
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
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
