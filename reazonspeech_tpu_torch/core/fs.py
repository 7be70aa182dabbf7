"""Filesystem helpers (parity: pkg/nemo-asr/src/fs.py:5-17).

A copy of ``reazonspeech_tpu/core/fs.py`` with the same behaviour."""

import sys
import tempfile

__all__ = ["create_tempfile"]


def create_tempfile():
    """Create a temporary file that can be re-opened by name on every
    platform. On win32, NamedTemporaryFile(delete=True) keeps the file locked
    while open, so deletion is deferred to close there."""
    if sys.platform == "win32":
        return tempfile.NamedTemporaryFile(delete=False)
    return tempfile.NamedTemporaryFile()
