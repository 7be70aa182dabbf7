"""Serving executors and the HTTP front (the port of
``reazonspeech_tpu/serving``): the static :class:`MicroBatcher`, the
lane-recycling :class:`ContinuousBatcher` and :func:`serve`."""

from .batcher import MicroBatcher
from .continuous import ContinuousBatcher
from .http import serve

__all__ = ["MicroBatcher", "ContinuousBatcher", "serve"]
