"""Share of the ALSD loop's steps (``decoding/rnnt_beam.py``) run by a CUDA
graph's replay: per batch of the traced window, the ``graph_steps`` attr of
the program's ``decode`` root over its ``steps``, in %, the median batch
(``utils.profiling``, read through ``portbench/spans.py``). Nothing where
the program records no ``graph_steps``."""

import statistics

from portbench.spans import window_decodes


def read(rec):
    batches = window_decodes(rec)
    if not batches or any("graph_steps" not in root.attrs for root, _ in batches):
        return None
    return statistics.median(100.0 * root.attrs["graph_steps"] / root.attrs["steps"]
                             for root, _ in batches)
