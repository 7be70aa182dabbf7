"""Device ms of the encoder (``models/fastconformer.py``,
``models/zipformer.py``) a batch: CUDA events around the encode in the
traced window, the median batch."""

import statistics


def read(rec):
    spans = [v for v in rec.get("spans", {}).get("encoder_ms", []) if v is not None]
    return statistics.median(spans) if spans else None
