#!/usr/bin/env python3
"""What the program's spans (``utils.profiling``) cost, and where they lie
on the profiler's clock, on the nemo-v2 offline batch (GPU; ``--cpu`` runs
a tiny model on the CPU, to rehearse).

    python3 tools/torch_span_cost.py [--batch 192] [--seconds 30] [--seed 0]

Loads nemo-v2 as its loader serves it (random weights), makes a batch of
speech-like chunks from the seed, warms up with one ``transcribe_batch``,
then:

1. the batch without a profiler, three times: its wall time, the spans
   it records and their milliseconds by name, the ``decode`` root's attrs, and the
   root's time against the sum of its children;
2. the same batch under ``torch.profiler`` (CPU and CUDA activity): its
   wall time; the ``rs.decode`` range against the store's ``decode``
   stamps on the profiler's clock (the trace's start plus an event's
   offset); of the kernels launched between the ``rs.encoder`` range's end
   and the ``rs.entry.copy_out`` range's start (the decode's), those whose
   launch (the runtime call of the same correlation id) lies outside
   ``rs.decode``; and the ``rs.`` names among the device's events, with
   their user-annotation flag;
3. the decode alone under a profiler of CUDA activity only (as the
   benchmark profiles it): the ``rs.`` names among its events;
4. a span's host cost: the mean of 100,000 empty spans, and of 10,000
   under a CPU profiler.

Prints the card's name and power limit first, and one ``SPANS`` JSON line
last.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from reazonspeech_tpu_torch.core.interface import AudioData  # noqa: E402
from reazonspeech_tpu_torch.utils import profiling  # noqa: E402

SR = 16000


def speech_like(seconds, rng):
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


def model_for(cpu):
    from reazonspeech_tpu_torch.nemo.asr.model import load_model

    if not cpu:
        return load_model(device="cuda", checkpoint="random")
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig

    enc = FastConformerConfig.tiny(compute_dtype="float32")
    return load_model("cpu", checkpoint="random", enc_cfg=enc,
                      rnnt_cfg=RNNTConfig.tiny(enc_dim=enc.d_model, compute_dtype="float32"))


def one_batch(model, audios, sync):
    """(wall s, the spans the batch recorded)."""
    from reazonspeech_tpu_torch.nemo.asr.transcribe import transcribe_batch

    profiling.reset()
    sync()
    t0 = time.perf_counter()
    transcribe_batch(model, audios)
    sync()
    return time.perf_counter() - t0, profiling.spans()


def decode_summary(spans):
    root = next(s for s in spans if s.name == "decode")
    kids = Counter()
    for s in spans:
        if s.parent == root.id:
            kids[s.name] += (s.end_ns - s.start_ns) / 1e6
    return root, {"attrs": root.attrs, "ms": (root.end_ns - root.start_ns) / 1e6,
                  "children_ms": dict(kids),
                  "children_share": sum(kids.values()) / ((root.end_ns - root.start_ns) / 1e6)}


def clock_check(prof, spans):
    """The rs.decode range against the store's decode stamps, and the
    decode's kernels launched outside it."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = list(prof.events())
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("rs."):
            ranges.setdefault(e.name, []).append(e)
    dec = ranges["rs.decode"][0]
    enc_end = ranges["rs.encoder"][0].time_range.end
    out_start = ranges["rs.entry.copy_out"][0].time_range.start
    root = next(s for s in spans if s.name == "decode")
    launch = {e.id: e.time_range.start for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cu")) and e.id}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    decode_kernels = [launch[e.id] for e in device if e.id in launch
                      and enc_end <= launch[e.id] <= out_start and not e.is_user_annotation]
    outside = sum(not (dec.time_range.start <= t <= dec.time_range.end) for t in decode_kernels)
    annotated = Counter((e.name, bool(e.is_user_annotation)) for e in device
                        if e.name.startswith("rs."))
    return {"range_us": [dec.time_range.start, dec.time_range.end],
            "start_gap_us": (t0 + dec.time_range.start * 1e3 - root.start_ns) / 1e3,
            "end_gap_us": (root.end_ns - (t0 + dec.time_range.end * 1e3)) / 1e3,
            "decode_kernels": len(decode_kernels), "launched_outside": outside,
            "device_rs_events": [[n, a, c] for (n, a), c in sorted(annotated.items())],
            "host_ranges": {k: len(v) for k, v in sorted(ranges.items())}}


def cuda_only_decode(model, audios, cpu):
    """The rs. names among the events of a decode profiled with CUDA
    activity alone (the benchmark's decode profile)."""
    from torch.profiler import ProfilerActivity, profile

    from reazonspeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode

    p = model.params
    n = max(len(a.waveform) for a in audios)
    wav = torch.zeros(len(audios), n)
    for i, a in enumerate(audios):
        wav[i, :len(a.waveform)] = torch.from_numpy(a.waveform)
    lens = torch.tensor([len(a.waveform) for a in audios], dtype=torch.int32)
    with torch.inference_mode():
        wav, lens = wav.to(model.device), lens.to(model.device)
        feats, flens = log_mel_spectrogram(wav, lens, model.fe_cfg)
        x, xlens = fastconformer_encode(p["encoder"], feats, flens, model.enc_cfg)
        acts = [ProfilerActivity.CPU] if cpu else [ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            rnnt_beam_decode(p["predictor"], p["joint"], x, xlens, model.rnnt_cfg,
                             model.decode_cfg)
            if not cpu:
                torch.cuda.synchronize()
    return sorted({(e.name, str(e.device_type), bool(e.is_user_annotation))
                   for e in prof.events() if e.name.startswith("rs.")})


def span_cost():
    from torch.profiler import ProfilerActivity, profile

    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("cost"):
            pass
    off = (time.perf_counter() - t0) / n * 1e6
    n_on = 10_000
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(n_on):
            with profiling.span("cost"):
                pass
        on = (time.perf_counter() - t0) / n_on * 1e6
    profiling.reset()
    return {"off_us": off, "profiled_us": on}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="a tiny model on the CPU (rehearsal)")
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    if not args.cpu:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --cpu to rehearse)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout,
              flush=True)
    sync = (lambda: None) if args.cpu else torch.cuda.synchronize
    model = model_for(args.cpu)
    rng = np.random.default_rng(args.seed)
    audios = [AudioData(speech_like(args.seconds, rng), SR) for _ in range(args.batch)]
    one_batch(model, audios, sync)  # warm-up
    for _ in range(3):
        wall, spans = one_batch(model, audios, sync)
        out = {"batch": args.batch, "seconds": args.seconds, "seed": args.seed,
               "wall_s": wall, "spans": dict(Counter(s.name for s in spans)),
               "ms": {name: sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6
                      for name in dict.fromkeys(s.name for s in spans)},
               "decode": decode_summary(spans)[1]}
        print("unprofiled", json.dumps(out), flush=True)
    acts = [ProfilerActivity.CPU] + ([] if args.cpu else [ProfilerActivity.CUDA])
    profiling.reset()
    with profile(activities=acts) as prof:
        wall_p, spans_p = one_batch(model, audios, sync)
    t0 = time.perf_counter()
    out["profiled"] = {"wall_s": wall_p, "decode": decode_summary(spans_p)[1],
                       "clock": clock_check(prof, spans_p)}
    out["profiled"]["reading_s"] = time.perf_counter() - t0
    del prof
    print("profiled", json.dumps(out["profiled"]), flush=True)
    out["cuda_only_decode"] = cuda_only_decode(model, audios[:8], args.cpu)
    out["span_cost"] = span_cost()
    print("SPANS", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
