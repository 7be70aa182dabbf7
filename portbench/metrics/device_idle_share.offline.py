"""The share of a batch's wall time in which no device activity ran, in %:
1 - (union of the profiled batch's kernel, copy and set intervals) / (the
median wall time of the traced window's batches, which run unprofiled).
The profiled batch's own wall is longer by the profiler's cost to the host
(``device.window_s``), so it is not the divisor."""

import statistics


def read(rec):
    busy, walls = rec.get("busy_s"), rec.get("spans", {}).get("batch_s")
    if not busy or not walls:
        return None
    return 100.0 * (1.0 - busy / statistics.median(walls))
