"""What the decode readers read of the program's own spans
(``reazonspeech_tpu_torch.utils.profiling``): the ``decode`` root of each
batch of the traced window, with the spans under it.

A traced run's decode roots are, in order, the warm-up's, one for each
batch of the window (as many as ``rec["spans"]["decode_ms"]``), and the
profiled batch's, last. Nothing is found (None) where the program records
no spans, or fewer roots than that.
"""


def window_decodes(rec):
    """[(root, [spans under it])] of the window's batches, or None."""
    try:
        from reazonspeech_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    k = len(rec.get("spans", {}).get("decode_ms", []))
    every = spans()
    roots = [s for s in every if s.name == "decode" and s.parent is None]
    if not k or len(roots) < k + 1:
        return None
    return [(r, [s for s in every if s.root == r.id and s is not r]) for r in roots[-k - 1:-1]]


def summed_ms(spans, name):
    """Milliseconds of the spans called ``name``, summed."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6
