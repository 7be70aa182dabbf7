"""Serving executors and the HTTP front (the port of
``reazonspeech_tpu/serving``): the static :class:`MicroBatcher`, the
lane-recycling :class:`ContinuousBatcher`, the AVSR flavor's
:class:`AVSRBatcher` and :func:`serve`."""

from .avsr import AVSRBatcher
from .batcher import MicroBatcher
from .continuous import ContinuousBatcher
from .http import serve

__all__ = ["AVSRBatcher", "ContinuousBatcher", "MicroBatcher", "serve"]
