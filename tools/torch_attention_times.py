#!/usr/bin/env python3
"""Device ms of the port's attention kernels at chip_smoke.py's shapes, for
the reazonspeech_tpu_torch of a given checkout (GPU only).

    python3 tools/torch_attention_times.py [CHECKOUT ...]

Each CHECKOUT (default: this repository) runs in a process of its own, in
the order given, so that two versions can be compared on one card in turns
(parent, change, change, parent). Per checkout one line: ``TIMES <path>``,
then ``label ms`` pairs: rows 1 and 7 (nemo's bucket, B=4, T=401, dh=128),
row 8 (espnet's window, T=549, B=1 and B=4), row 9 (T=1149), the espnet
packed route (T=499, dh=64) and rows 10-11 at the k2 shapes, each the
torch.profiler device time of one call (the mean of 20).
"""

import os
import subprocess
import sys


def times(root):
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import reazonspeech_tpu_torch as pkg
    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops._kernels import load_library
    from reazonspeech_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_blockwise,
    )

    if not pkg.__file__.startswith(root):
        raise SystemExit(f"imported {pkg.__file__}, not the checkout {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    load_library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    def device_ms(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the tracer drops a profile now and then
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
            if us > 0:
                return us / 1e3 / calls
        return float("nan")

    def lengths(*lens):
        return torch.tensor(lens, dtype=torch.int32, device=dev)

    f32, res = torch.float32, {}
    b, t, d, h = 4, 401, 1024, 8
    lens = lengths(401, 388, 200, 57)
    qkv, pos = rand(b, t, 3 * d, scale=0.5), rand(2 * t - 1, h, d // h, scale=0.5)
    bu, bv = rand(h, d // h, scale=0.1, dtype=f32), rand(h, d // h, scale=0.1, dtype=f32)
    res["row7 packed T=401"] = device_ms(
        lambda: ops.relpos_attention_fused_packed(qkv, pos, bu, bv, lens, h))
    q, k, v = (rand(b, t, d, scale=0.5) for _ in range(3))
    res["row1 fused T=401"] = device_ms(
        lambda: ops.relpos_attention_fused(q, k, v, pos, bu, bv, lens, h))

    def bhtd(b, t, *lens):
        return tuple(rand(b, 8, t, 64, scale=0.5) for _ in range(4)) + (
            rand(2 * t - 1, 8, 64, scale=0.5), lengths(*lens))

    a = bhtd(1, 549, 549)
    res["row8 B=1 T=549"] = device_ms(lambda: relpos_attention(*a))
    a4 = bhtd(4, 549, 549, 549, 520, 301)
    res["row8 B=4 T=549"] = device_ms(lambda: relpos_attention(*a4))
    a9 = bhtd(1, 1149, 1149)
    res["row9 T=1149"] = device_ms(lambda: relpos_attention_blockwise(*a9))
    qkv5, pos5 = rand(1, 499, 1536, scale=0.5), rand(997, 8, 64, scale=0.5)
    bu5, bv5 = rand(8, 64, scale=0.1, dtype=f32), rand(8, 64, scale=0.1, dtype=f32)
    res["espnet packed T=499"] = device_ms(
        lambda: ops.relpos_attention_fused_packed(qkv5, pos5, bu5, bv5, lengths(499), 8))

    def shared(g, t, dv, heads):
        lens = [t, 1] + [max(1, t - 37 * i) for i in range(2, g)] if g > 1 else [t]
        return (rand(g, t, 32, scale=0.5), rand(g, t, 32, scale=0.5), rand(g, t, 4),
                rand(heads, 2 * t - 1, 4), rand(g, t, dv), lengths(*lens))

    for label, g, t, dv, heads in (("stack 0", 16, 1596, 12, 4), ("stack 3", 32, 200, 12, 8),
                                   ("nonlin stack 0", 4, 1596, 144, 1),
                                   ("nonlin stack 3", 4, 200, 576, 1)):
        a = shared(g, t, dv, heads)
        res["row10 " + label] = device_ms(lambda: ops.shared_rel_attention(*a, heads=heads))
    for label, g, dv, heads in (("T=3196", 4, 12, 4), ("nonlin T=3196", 1, 144, 1)):
        a = shared(g, 3196, dv, heads)
        res["row11 " + label] = device_ms(
            lambda: ops.shared_rel_attention_blockwise(*a, heads=heads))
    print("TIMES", root, " | ".join(f"{k} {v:.4f}" for k, v in res.items()), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        times(sys.argv[2])
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for root in sys.argv[1:] or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root)], check=True)


if __name__ == "__main__":
    main()
