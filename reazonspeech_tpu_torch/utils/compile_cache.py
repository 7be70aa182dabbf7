"""Persistent build cache: warm restarts.

Port of ``reazonspeech_tpu/utils/compile_cache.py``. What the JAX package
caches is XLA's compiled programs; what the port compiles is its CUDA
kernel library (``ops/_kernels.py``: one nvcc per ``csrc/*.cu``, about a
minute cold) and the host-side ``native/`` library (g++). Both are named
by a hash of their sources and flags, so a directory that holds them is a
content-addressed cache: a restart, or another checkout of the same
sources, loads them without compiling. By default they build into
``build/torch_kernels/`` and ``build/torch_native/`` beside the package.

Opt-in: pass ``reazonspeech-serve --compile-cache DIR`` or set
``$REAZONSPEECH_TPU_COMPILE_CACHE``. Safe to share between flavors and
processes (each library is published with an atomic rename).
"""

import os
from pathlib import Path

__all__ = ["ENV_VAR", "enable_compile_cache"]

ENV_VAR = "REAZONSPEECH_TPU_COMPILE_CACHE"


def enable_compile_cache(path=None, min_compile_secs=1.0):
    """Point the kernel library's and the native library's build
    directories at ``path`` (``path/torch_kernels``, ``path/torch_native``).

    ``path`` defaults to ``$REAZONSPEECH_TPU_COMPILE_CACHE``; when both
    are unset this is a no-op returning None (the libraries build under
    ``build/``). It has effect only before the process first loads a
    library (``ops._kernels.load_library()``, ``native.available()``): a
    loaded library stays loaded. ``min_compile_secs`` is accepted for the
    JAX signature and has no counterpart: both libraries are always worth
    keeping.

    Returns the cache directory in use, or None when disabled.
    """
    del min_compile_secs  # no counterpart: see the docstring
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    from .. import native
    from ..ops import _kernels

    os.makedirs(path, exist_ok=True)
    _kernels.BUILD_DIR = Path(path) / "torch_kernels"
    native.BUILD_DIR = Path(path) / "torch_native"
    return path
