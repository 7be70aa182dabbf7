"""Host ms of the decode (``decoding/rnnt_beam.py``) a batch: the host
clock from the call to a synchronise after it (the encoder already
finished), the median batch of the traced window."""

import statistics


def read(rec):
    spans = rec.get("spans", {}).get("decode_ms", [])
    return statistics.median(spans) if spans else None
