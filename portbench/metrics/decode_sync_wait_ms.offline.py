"""Host milliseconds the ALSD loop (``decoding/rnnt_beam.py``) spends at
its termination checks, the loop's only syncs, where the host waits for
the device to finish the steps it dispatched: per batch of the traced window,
the program's ``decode.check`` spans under its ``decode`` root summed; the
median batch (``utils.profiling``, read through ``portbench/spans.py``)."""

import statistics

from portbench.spans import summed_ms, window_decodes


def read(rec):
    batches = window_decodes(rec)
    if not batches:
        return None
    return statistics.median(summed_ms(kids, "decode.check") for _, kids in batches)
