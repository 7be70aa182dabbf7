"""``ops.ln_dense``'s share of its roofline (``ops/ln_dense.py``,
``csrc/ln_dense.cu``), in %: over the profiled batch's calls from the
FastConformer's FFNs, the least time the chip could take (``frozen.bound_ms``
of ``frozen.flops_ln_dense``: the larger of the call's bytes over the HBM
rate and its products over the bf16 peak) over the device time of every
kernel launched inside the benchmark's range around the call, whatever
implements it."""

from portbench.frozen import bound_ms, flops_ln_dense

RANGES = {"ln_dense": [("reazonspeech_tpu_torch.models.fastconformer", "ln_dense")]}


def read(rec):
    device_ms, calls = rec.get("ranges", ({}, {}))
    spent = device_ms.get("ln_dense", 0.0)
    if not spent or not calls.get("ln_dense"):
        return None
    bound = sum(bound_ms(flops_ln_dense(args, out), args, out)[0]
                for args, out in calls["ln_dense"])
    return 100.0 * bound / spent
