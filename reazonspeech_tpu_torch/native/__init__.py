"""ctypes bindings to the native host-side kernels (``src/native.cc``).

A copy of ``reazonspeech_tpu/native/__init__.py`` (jax-free; the port keeps
its own, as it does ``core/``) with its own build: the library is compiled
with ``g++`` at first use into ``build/torch_native/`` beside the package
(or the directory :func:`reazonspeech_tpu_torch.utils.enable_compile_cache`
sets), named by a hash of the source and the flags, and published with an
atomic ``os.replace`` so that processes building at once never load a
partial file. ``native.cc`` is the JAX package's, unchanged; ``Makefile``
builds the same file with the same flags by hand.

Every binding has a pure-Python path at its call site (``core.text``,
``training.data``): :func:`available` is false only where no C++ compiler
exists, and a compiler that fails raises. Nothing is built at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build_info", "edit_distance", "ts_scan_pid", "pcm16_to_f32",
           "downmix_mean", "wav_info", "wav_batch_load"]

SOURCE = Path(__file__).resolve().parent / "src" / "native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# C entry -> (restype, argtypes)
_SIGNATURES = {
    "rs_edit_distance": (_I64, [_P, _I64, _P, _I64]),
    "rs_pcm16_to_f32": (None, [_P, _I64, _P]),
    "rs_ts_scan_pid": (_I64, [_P, _I64, _I32, _I32, _P, _I64]),
    "rs_downmix_mean": (None, [_P, _I64, _I32, _P]),
    "rs_wav_info": (_I32, [ctypes.c_char_p, _P, _P]),
    "rs_wav_batch_load": (None, [ctypes.POINTER(ctypes.c_char_p), _I32, _P, _I64, _P, _I32]),
}

_lock = threading.Lock()
_lib = None
_info = {}


def _compiler():
    """The C++ compiler ($CXX, else g++ on PATH), or None."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _build(cxx):
    digest = hashlib.sha256(" ".join([os.path.basename(cxx)] + CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"librs_native_{digest.hexdigest()[:16]}.so"
    if so.exists():
        _info.update(path=str(so), log="(cached)")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        built = Path(tmp) / so.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(built), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(built, so)  # atomic: a concurrent build never sees a partial file
    _info.update(path=str(so), log=proc.stderr or "(built)")
    return so


def _load():
    """The library (built on first call), or None where no compiler exists."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            if cxx is None:
                _lib = False
            else:
                lib = ctypes.CDLL(str(_build(cxx)))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
    return _lib


def _require():
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable: no C++ compiler ($CXX or g++)")
    return lib


def available() -> bool:
    """True once the library is loaded (building it if need be); False only
    where no C++ compiler exists."""
    return bool(_load())


def build_info():
    """{path, log} of the library this process loaded; ``log`` is
    "(cached)" where an earlier build was found."""
    return dict(_info)


def edit_distance(s: str, t: str) -> int:
    lib = _require()
    a = np.frombuffer(s.encode("utf-32-le"), np.uint32)
    b = np.frombuffer(t.encode("utf-32-le"), np.uint32)
    return int(lib.rs_edit_distance(a.ctypes.data, len(a), b.ctypes.data, len(b)))


def ts_scan_pid(data: bytes, pid: int, require_pusi: bool = True) -> np.ndarray:
    """Byte offsets of 188-byte TS packets matching pid (and PUSI)."""
    lib = _require()
    buf = np.frombuffer(data, np.uint8)
    max_out = len(data) // 188 + 1
    out = np.zeros(max_out, np.int64)
    n = lib.rs_ts_scan_pid(buf.ctypes.data, len(buf), pid, int(require_pusi), out.ctypes.data,
                           max_out)
    return out[:n]


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    lib = _require()
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(pcm.shape, np.float32)
    lib.rs_pcm16_to_f32(pcm.ctypes.data, pcm.size, out.ctypes.data)
    return out


def downmix_mean(x: np.ndarray) -> np.ndarray:
    """[frames, channels] float32 -> [frames] mono."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    frames, ch = x.shape
    out = np.empty(frames, np.float32)
    lib.rs_downmix_mean(x.ctypes.data, frames, ch, out.ctypes.data)
    return out


def wav_info(path):
    """(sample_rate, mono_frames) from the WAV header only."""
    lib = _require()
    sr = ctypes.c_int32()
    n = ctypes.c_int64()
    if lib.rs_wav_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(n)) != 0:
        raise OSError(f"not a readable PCM WAV: {path}")
    return int(sr.value), int(n.value)


def wav_batch_load(paths, stride, num_threads=8):
    """Decode WAV files concurrently into a zero-padded [n, stride] float32
    batch (mono mean-downmix). Returns (batch, lengths); a length of -1
    marks a file the native decoder refused (caller falls back per-file)."""
    lib = _require()
    n = len(paths)
    out = np.zeros((n, stride), np.float32)
    lengths = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.rs_wav_batch_load(arr, n, out.ctypes.data, stride, lengths.ctypes.data, num_threads)
    return out, lengths
