#!/usr/bin/env python3
"""Times of the port's beam-decoder step kernels at chip_smoke.py's shapes,
for the reazonspeech_tpu_torch of a given checkout (GPU only).

    python3 tools/torch_topm_times.py [CHECKOUT ...]

Each CHECKOUT (default: this repository) runs in a process of its own, in
the order given, so that two versions can be compared on one card in turns
(parent, change, change, parent). Per checkout one line, ``TIMES <path>``,
then ``label device-ms/events-ms`` pairs:

- row 3 (``topm_logsoftmax``): nemo ALSD (R=16, V=3,001, m=4, fp32),
  espnet Graves (R=80, V=2,182, m=20), m=40 on nemo's V and on V=50,000;
  beside each ``torch.amax`` over the same logits (one reduction reading
  the same bytes: a yardstick);
- row 12 (``joint_topm``): nemo ALSD (R=16, H=J=640, V=3,001, m=4, relu),
  espnet Graves (R=4, H=J=256, V=2,182, m=20, tanh) and k2 ALSD (R=16,
  H=J=512, V=2,179, m=4, tanh), with the span from the first kernel's start
  to the last one's end beside the summed device ms, and each device
  kernel's ms; beside them the bare fp32 cuBLAS products dec·Wp and z·Wo
  (TF32 off: a yardstick);
- row 13 (``lstm_cell_step``) at nemo's predictor (R=16, H_in=H=640),
  espnet's (R=4, H=256) and nemo ALSD beam 40 x 4 lanes (R=160, H=640),
  each with its bound (bytes over 3.35 TB/s or fp32 FMAs over 67 TFLOP/s)
  and beside ``torch.lstm_cell`` (the same function, weights as [4H, in]),
  and beside ``torch.amax`` over the two weight matrices (one reduction
  reading the same 13.1 MB once: a yardstick of the weights' read alone),
  each once back-to-back (warm L2) and once cold: a 64 MB buffer written
  before each call (device ms of the call's kernels alone; events ms of the
  fill and the call, and of the fill alone).

Device ms: torch.profiler, the mean of 50 calls (the span: their median);
events ms: CUDA events over 200 back-to-back calls after a warm-up (the
host's enqueue included).
The script also prints the card's name and power limit.
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
    from reazonspeech_tpu_torch.ops import _kernels

    if not pkg.__file__.startswith(root):
        raise SystemExit(f"imported {pkg.__file__}, not the checkout {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    f32 = torch.float32

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=f32)

    kernels = {}  # the last profile's kernels: name -> device ms a call

    def device_kernels(fn, calls=50):
        """[(start, end)] in µs of every device kernel of ``calls`` calls
        (and each kernel's device ms a call into ``kernels``)."""
        kernels.clear()
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the tracer drops a profile now and then
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if evs:
                for name in sorted({e.name for e in evs}):
                    us = [e.time_range.end - e.time_range.start for e in evs if e.name == name]
                    kernels[name[:48]] = sum(us) / 1e3 / calls
                return sorted((e.time_range.start, e.time_range.end) for e in evs)
        return []

    def timed(fn, per_call=None):
        """(device ms: summed kernel time a call, span ms a call or None,
        events ms a call); the span groups ``per_call`` kernels a call and
        runs from the first one's start to the last one's end."""
        calls = 50
        ks = device_kernels(fn, calls)
        dev_ms = sum(e - s for s, e in ks) / 1e3 / calls if ks else float("nan")
        span = None
        if per_call and len(ks) == calls * per_call:
            groups = [ks[i:i + per_call] for i in range(0, len(ks), per_call)]
            spans = sorted(max(e for _, e in g) - g[0][0] for g in groups)
            span = spans[len(spans) // 2] / 1e3  # the median: the profile's first call lags
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn()
        end.record()
        torch.cuda.synchronize()
        return dev_ms, span, start.elapsed_time(end) / 200

    res = {}

    def put(label, t):
        dev_ms, span, ev = t
        res[label] = f"{dev_ms:.4f}" + (f" (span {span:.4f})" if span is not None else "") + \
            f" / {ev:.4f}"

    for label, r, v, m, blank in (("nemo R=16 V=3001 m=4", 16, 3001, 4, 3000),
                                  ("Graves R=80 V=2182 m=20", 80, 2182, 20, 0),
                                  ("R=16 V=3001 m=40", 16, 3001, 40, 3000),
                                  ("R=4 V=50000 m=40", 4, 50000, 40, 0)):
        x = rand(r, v, scale=3.0)
        put("row3 " + label, timed(lambda: ops.topm_logsoftmax(x, m, blank)))
        put("amax " + label, timed(lambda: torch.amax(x, dim=-1)))

    acts = {"relu": torch.relu, "tanh": torch.tanh}
    for label, r, h, v, blank, act, m in (("nemo R=16 H=J=640 V=3001 m=4", 16, 640, 3001, 3000,
                                           "relu", 4),
                                          ("Graves R=4 H=J=256 V=2182 m=20", 4, 256, 2182, 0,
                                           "tanh", 20),
                                          ("k2 R=16 H=J=512 V=2179 m=4", 16, 512, 2179, 0,
                                           "tanh", 4)):
        args = (rand(h, h, scale=h ** -0.5), rand(h, scale=0.1), rand(h, v, scale=h ** -0.5),
                rand(v, scale=0.1), rand(r, h), rand(r, h))
        kw = dict(activation=act, compute_dtype="float32")
        call = lambda: ops.joint_topm(*args, m, blank, **kw)  # noqa: E731
        per_call = len(device_kernels(call, 1))
        put("row12 " + label, timed(call, per_call))
        res["row12 kernels " + label] = ", ".join(f"{k} {v:.4f}" for k, v in kernels.items())
        z = acts[act](args[4] + (args[5] @ args[0] + args[1]))
        put("cuBLAS dec.Wp + z.Wo " + label,
            timed(lambda: (torch.matmul(args[5], args[0]), torch.matmul(z, args[2]))))

    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB, written between cold calls

    def timed_cold(fn):
        """(device ms of fn's kernels a call, events ms of fill + fn a call,
        events ms of the fill alone) with the 64 MB buffer written before
        each call, so that fn's inputs are no longer in the 50 MB L2."""
        def pair():
            flush.fill_(1.0)
            fn()

        pair()
        torch.cuda.synchronize()
        dev_ms = float("nan")
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    pair()
                torch.cuda.synchronize()
            us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.name]
            if us:
                dev_ms = sum(us) / 1e3 / 50
                break
        ev = []
        for f in (pair, lambda: flush.fill_(1.0)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                f()
            end.record()
            torch.cuda.synchronize()
            ev.append(start.elapsed_time(end) / 50)
        return f"{dev_ms:.4f} / {ev[0]:.4f} (fill alone {ev[1]:.4f})"

    for label, r, h in (("nemo R=16 H=640", 16, 640), ("espnet R=4 H=256", 4, 256),
                        ("nemo beam 40 R=160 H=640", 160, 640)):
        largs = (rand(h, 4 * h, scale=h ** -0.5), rand(h, 4 * h, scale=h ** -0.5),
                 rand(4 * h, scale=0.1), rand(r, h), rand(r, h, scale=0.5), rand(r, h))
        w_ih_t, w_hh_t = largs[0].t().contiguous(), largs[1].t().contiguous()
        zero = torch.zeros_like(largs[2])
        call = lambda: ops.lstm_cell_step(*largs, compute_dtype="float32")  # noqa: E731
        lib = lambda: torch.lstm_cell(largs[3], (largs[4], largs[5]), w_ih_t, w_hh_t,  # noqa: E731
                                      largs[2], zero)
        moved = 4 * (2 * h * 4 * h + 4 * h + 3 * r * h + 2 * r * h)
        flops = 2.0 * r * 2 * h * 4 * h + 10.0 * r * h
        t_mem, t_ops = moved / 3.35e12, flops / 67e12
        res["row13 bound " + label] = \
            f"{max(t_mem, t_ops) * 1e3:.4f} ({'bytes' if t_mem > t_ops else 'operations'})"
        put("row13 " + label, timed(call))
        res["row13 cold " + label] = timed_cold(call)
        put("torch.lstm_cell " + label, timed(lib))
        res["torch.lstm_cell cold " + label] = timed_cold(lib)
        weights = torch.cat([largs[0], largs[1]])
        put("torch.amax over W_ih|W_hh " + label, timed(lambda: torch.amax(weights)))
        res["torch.amax over W_ih|W_hh cold " + label] = timed_cold(lambda: torch.amax(weights))
    print("TIMES", root, " | ".join(f"{k} {v}" for k, v in res.items()), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        times(sys.argv[2])
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for root in sys.argv[1:] or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root)], check=True)


if __name__ == "__main__":
    main()
