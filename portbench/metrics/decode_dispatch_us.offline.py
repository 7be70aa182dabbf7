"""Host microseconds a step of the ALSD loop (``decoding/rnnt_beam.py``)
takes to dispatch: per batch of the traced window, the program's
``decode.dispatch`` spans (one a block of ``CHECK_EVERY`` bodies) summed,
over the ``steps`` attr of their ``decode`` root (the bodies dispatched); the
median batch (``utils.profiling``, read through ``portbench/spans.py``)."""

import statistics

from portbench.spans import summed_ms, window_decodes


def read(rec):
    batches = window_decodes(rec)
    if not batches:
        return None
    return statistics.median(1e3 * summed_ms(kids, "decode.dispatch") / root.attrs["steps"]
                             for root, kids in batches)
