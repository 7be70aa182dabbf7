#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reazonspeech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch twin at the nemo-v2
   slice's shapes, with the tolerance stated beside each check, and both
   times (CUDA events, after warm-up);
4. main path: load_model(device="cuda", checkpoint="random") at the full
   xlarge width (24 blocks, d=1024), transcribe_batch of 4 x 30 s and a
   chunked transcribe of 70 s, with every kernel's launch count > 0 over
   that run; then the encoder and the ALSD decode on a short input against
   the same path with the plain twins in place of the kernels;
5. the kernels' JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports no JAX. Runs in a few minutes, the build included.
"""

import contextlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SR = 16000
REPLACES = {
    "relpos_attention_fused": "reazonspeech_tpu/ops/relpos_attention.py:341",
    "fused_conv_module": "reazonspeech_tpu/ops/conformer_conv.py:98",
    "topm_logsoftmax": "reazonspeech_tpu/ops/beam_topk.py:66",
}
SOURCES = {
    "relpos_attention_fused": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "fused_conv_module": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
    "topm_logsoftmax": "reazonspeech_tpu_torch/csrc/beam_topk.cu",
}


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() in ms over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def speech_like(seconds, seed):
    """Amplitude-modulated noise (as bench.py makes its inputs)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


# --- phase 3: kernels against their plain twins ------------------------------


def kernel_checks(dev):
    import torch

    from reazonspeech_tpu_torch import ops

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    f32, rows = torch.float32, []
    b, t, d, h, k = 4, 376, 1024, 8, 9
    lengths = torch.tensor([376, 300, 177, 41], dtype=torch.int32, device=dev)

    # attention: both round the probabilities to bf16 before p·v (the JAX
    # kernel's chain; the kernel before normalising, the twin after) and the
    # output to bf16 -> a few bf16 ulps at |out| <= ~1
    q, kk, v = (rand(b, t, d, scale=0.5) for _ in range(3))
    pos = rand(2 * t - 1, h, d // h, scale=0.5)
    bu, bv = rand(h, d // h, scale=0.1, dtype=f32), rand(h, d // h, scale=0.1, dtype=f32)
    args = (q, kk, v, pos, bu, bv, lengths, h)
    rows.append(_compare("relpos_attention_fused", ops.relpos_attention_fused,
                         ops.relpos_attention_fused_plain, args, atol=0.03, iters=20))

    # conv module: fp32 inside both; bf16 rounding of y and of the output can
    # land one ulp apart where the fp32 sums differ in order
    w_in = rand(d, 2 * d, scale=d ** -0.5, dtype=f32)
    args = (rand(b, t, d), lengths, w_in, rand(2 * d, scale=0.1, dtype=f32),
            rand(k, 1, d, scale=k ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32),
            1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32),
            rand(d, d, scale=d ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32))
    rows.append(_compare("fused_conv_module", ops.fused_conv_module,
                         ops.fused_conv_module_plain, args, atol=0.03, iters=20))

    # top-m: fp32 sums in another order (1e-4); indices exactly, ties included
    logits = rand(16, 3001, scale=3.0, dtype=f32)
    rows.append(_compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                         (logits, 4, 3000), atol=1e-4, iters=200))
    ties = torch.randint(-3, 4, (16, 3001), generator=gen).to(device=dev, dtype=f32)
    got, want = ops.topm_logsoftmax(ties, 4, 3000), ops.topm_logsoftmax_plain(ties, 4, 3000)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), "topm_logsoftmax: tie order differs from the plain twin")
    log("topm_logsoftmax integer-tie case: indices equal")
    return rows


def _compare(name, kernel, plain, args, atol, iters):
    import torch

    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if isinstance(got, tuple):  # topm: indices must be equal, values within atol
        check(torch.equal(got[2], want[2]), f"{name}: indices differ from the plain twin")
        err = max((g - w).abs().max().item() for g, w in zip(got[:2], want[:2]))
    else:
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
        check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
    check(err <= atol, f"{name}: max abs err {err} > {atol}")
    ms = cuda_ms(lambda: kernel(*args), iters)
    plain_ms = cuda_ms(lambda: plain(*args), iters)
    log(f"{name}: max_abs_err={err:.3g} (tol {atol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms}


# --- phase 4: the main path ---------------------------------------------------


@contextlib.contextmanager
def plain_twins():
    """Run the same path with every kernel wrapper's plain twin in its place."""
    from reazonspeech_tpu_torch.decoding import rnnt_beam
    from reazonspeech_tpu_torch.models import fastconformer as fc
    from reazonspeech_tpu_torch.ops import conformer_conv as cc
    from reazonspeech_tpu_torch.ops import relpos_attention as ra

    saved = (fc.relpos_attention_fused, fc.fused_conv_module, rnnt_beam.topm_logsoftmax)
    fc.relpos_attention_fused = ra.relpos_attention_fused_plain
    fc.fused_conv_module = cc.fused_conv_module_plain
    rnnt_beam.topm_logsoftmax = rnnt_beam.topm_logsoftmax_plain
    try:
        yield
    finally:
        fc.relpos_attention_fused, fc.fused_conv_module, rnnt_beam.topm_logsoftmax = saved


def check_results(results, durations):
    for r, dur in zip(results, durations):
        secs = [s.seconds for s in r.subwords]
        check(isinstance(r.text, str), "text is not a string")
        check(secs == sorted(secs) and all(0 <= s <= dur + 1.0 for s in secs),
              f"subword times out of order or range: {secs[:8]}")
        check(all(s.end_seconds > s.start_seconds for s in r.segments), "empty segment")


def main_path(dev, name):
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.nemo.asr import (
        TranscribeConfig, audio_from_numpy, load_model, transcribe, transcribe_batch,
    )

    t0 = time.perf_counter()
    model = load_model(device="cuda", checkpoint="random")
    torch.cuda.synchronize()
    cfg = model.enc_cfg
    log(f"load_model: {time.perf_counter() - t0:.1f} s; {cfg.num_layers} blocks, d={cfg.d_model}, "
        f"heads={cfg.num_heads}, attn={cfg.attn_impl}, conv={cfg.conv_impl}, "
        f"{cfg.compute_dtype}/{cfg.residual_dtype}, decode={model.decode_cfg}")
    check((cfg.d_model, cfg.num_layers, cfg.num_heads) == (1024, 24, 8), "not the xlarge width")

    batch = [audio_from_numpy(speech_like(30.0, seed=i), SR) for i in range(4)]
    long_form = audio_from_numpy(speech_like(70.0, seed=9), SR)
    transcribe_batch(model, batch[:1])  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_batch = transcribe_batch(model, batch)
    t1 = time.perf_counter()
    res_long = transcribe(model, long_form, TranscribeConfig(chunk_seconds=30.0))
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    log(f"launch counts over the main path: {counts}")
    check(all(n > 0 for n in counts.values()), f"a kernel was not launched: {counts}")
    check_results(res_batch, [30.0] * 4)
    check_results([res_long], [70.0])
    rate_b, rate_l = 120.0 / (t1 - t0), 70.0 / (t2 - t1)
    log(f"transcribe_batch 4 x 30 s: {t1 - t0:.3f} s wall, {rate_b:.2f} audio-s/s on {name}")
    log(f"transcribe 70 s chunked (30 s chunks): {t2 - t1:.3f} s wall, {rate_l:.2f} audio-s/s "
        f"on {name}")
    log(f"subwords: batch {[len(r.subwords) for r in res_batch]}, long {len(res_long.subwords)}")
    reference_check(model)
    return counts


def reference_check(model):
    """A short batch through the kernel path and through the same path with
    the plain twins: the encoder output agrees to bf16 noise accumulated over
    24 blocks (relative L2 <= 5e-2), and ALSD on one encoder output gives the
    same tokens with the top-m kernel as with its plain twin."""
    import torch

    from reazonspeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode

    wav = np.stack([speech_like(5.0, seed=20), speech_like(5.0, seed=21)])
    wav[1, 3 * SR:] = 0.0
    with torch.inference_mode():
        w = torch.from_numpy(wav).to(model.device)
        lens = torch.tensor([5 * SR, 3 * SR], dtype=torch.int32, device=model.device)
        feats, fl = log_mel_spectrogram(w, lens, model.fe_cfg)
        enc, el = fastconformer_encode(model.params["encoder"], feats, fl, model.enc_cfg)
        with plain_twins():
            ref, _ = fastconformer_encode(model.params["encoder"], feats, fl, model.enc_cfg)
        check(bool(torch.isfinite(enc).all()), "non-finite encoder output")
        valid = (torch.arange(enc.shape[1], device=enc.device)[None, :] < el[:, None])[..., None]
        rel = ((enc - ref) * valid).norm().item() / (ref * valid).norm().item()
        log(f"encoder, kernels vs plain twins: relative L2 {rel:.3g} (tol 5e-2)")
        check(rel <= 5e-2, f"encoder relative error {rel}")
        pp, jp = model.params["predictor"], model.params["joint"]
        got = rnnt_beam_decode(pp, jp, enc, el, model.rnnt_cfg, model.decode_cfg)
        with plain_twins():
            want = rnnt_beam_decode(pp, jp, enc, el, model.rnnt_cfg, model.decode_cfg)
    for g, w_, what in zip(got[:3], want[:3], ("tokens", "frames", "counts")):
        check(torch.equal(g, w_), f"ALSD {what} differ between the top-m kernel and its twin")
    log(f"ALSD with the top-m kernel == with its plain twin: counts {got[2].tolist()}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from reazonspeech_tpu_torch.ops import _kernels

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _kernels.load_library()
    info = _kernels.build_info()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s): "
        f"{info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    rows = kernel_checks(dev)
    counts = main_path(dev, f"{smi}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # any failed phase: report it, exit nonzero, print no result
        traceback.print_exc()
        sys.exit(1)
