"""Device ms of the frontend (``frontend/features.py``) a batch: CUDA events
around ``log_mel_spectrogram`` in the traced window, the median batch."""

import statistics


def read(rec):
    spans = [v for v in rec.get("spans", {}).get("frontend_ms", []) if v is not None]
    return statistics.median(spans) if spans else None
