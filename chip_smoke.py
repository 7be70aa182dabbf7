#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reazonspeech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch twin at the shapes the
   main path gives it (the 4 x 32 s bucket: B=4, T=401, D=1024), the two
   kernels of the lnd_impl="xla" configuration also at an unaligned T=376,
   with the tolerance stated beside each check, and both times (CUDA
   events, after warm-up); the kernels' JSON line reports the T=401 runs;
4. main path: load_model(device="cuda", checkpoint="random") in its GPU
   serving configuration (lnd_impl="pallas": every encoder kernel) at the
   full xlarge width and depth (24 blocks, d=1024), transcribe_batch of
   4 x 30 s and a chunked transcribe of 70 s; then the earlier
   configuration (lnd_impl="xla", whose attention and conv kernels take
   separate q/k/v and a caller-side LayerNorm) at full width and 4 blocks
   through one transcribe_batch. Launch counts are reset before and read
   after each path, and every kernel of each path must have launched.
   Then, on a short input: the encoder and the ALSD decode against the same
   path with the plain twins in place of the kernels, and the encoder
   against the lnd_impl="xla" configuration on the same weights;
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
    "ln_dense": "reazonspeech_tpu/ops/ln_dense.py:75",
    "ln_dense_add": "reazonspeech_tpu/ops/ln_dense.py:193",
    "add_ln": "reazonspeech_tpu/ops/ln_dense.py:300",
    "relpos_attention_fused_packed": "reazonspeech_tpu/ops/relpos_attention.py:402",
    "fused_conv_module_ln": "reazonspeech_tpu/ops/conformer_conv.py:98",
}
SOURCES = {
    "relpos_attention_fused": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "fused_conv_module": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
    "topm_logsoftmax": "reazonspeech_tpu_torch/csrc/beam_topk.cu",
    "ln_dense": "reazonspeech_tpu_torch/csrc/ln_dense.cu",
    "ln_dense_add": "reazonspeech_tpu_torch/csrc/ln_dense.cu",
    "add_ln": "reazonspeech_tpu_torch/csrc/ln_dense.cu",
    "relpos_attention_fused_packed": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "fused_conv_module_ln": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
}
# the kernels each configuration's encoder and decoder launch
SERVING_KERNELS = ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed",
                   "fused_conv_module_ln", "add_ln", "topm_logsoftmax")
EARLIER_KERNELS = ("relpos_attention_fused", "fused_conv_module", "topm_logsoftmax")


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

    f32 = torch.float32
    b, t, d, h, k = 4, 376, 1024, 8, 9
    lengths = torch.tensor([376, 300, 177, 41], dtype=torch.int32, device=dev)

    # attention: both round the probabilities to bf16 before p·v (the JAX
    # kernel's chain; the kernel before normalising, the twin after) and the
    # output to bf16 -> a few bf16 ulps at |out| <= ~1
    q, kk, v = (rand(b, t, d, scale=0.5) for _ in range(3))
    pos = rand(2 * t - 1, h, d // h, scale=0.5)
    bu, bv = rand(h, d // h, scale=0.1, dtype=f32), rand(h, d // h, scale=0.1, dtype=f32)
    args = (q, kk, v, pos, bu, bv, lengths, h)
    _compare("relpos_attention_fused", ops.relpos_attention_fused,
             ops.relpos_attention_fused_plain, args, atol=0.03, iters=20, label="T=376")

    # conv module: fp32 inside both; bf16 rounding of y and of the output can
    # land one ulp apart where the fp32 sums differ in order
    w_in = rand(d, 2 * d, scale=d ** -0.5, dtype=f32)
    args = (rand(b, t, d), lengths, w_in, rand(2 * d, scale=0.1, dtype=f32),
            rand(k, 1, d, scale=k ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32),
            1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32),
            rand(d, d, scale=d ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32))
    _compare("fused_conv_module", ops.fused_conv_module, ops.fused_conv_module_plain, args,
             atol=0.03, iters=20, label="T=376")

    # top-m: fp32 sums in another order (1e-4); indices exactly, ties included
    logits = rand(16, 3001, scale=3.0, dtype=f32)
    rows = [_compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                     (logits, 4, 3000), atol=1e-4, iters=200)]
    ties = torch.randint(-3, 4, (16, 3001), generator=gen).to(device=dev, dtype=f32)
    got, want = ops.topm_logsoftmax(ties, 4, 3000), ops.topm_logsoftmax_plain(ties, 4, 3000)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), "topm_logsoftmax: tie order differs from the plain twin")
    log("topm_logsoftmax integer-tie case: indices equal")
    return rows + bucket_kernel_checks(rand, dev)


def bf16_tol(want):
    """2 bf16 ulps at the largest |value|: the kernel and the twin round at
    the same points, only their fp32 sums differ in order."""
    return 2.0 * 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)


def bucket_kernel_checks(rand, dev):
    """The encoder kernels at the 4 x 32 s bucket's shapes (B=4, T=401
    encoder frames, D=1024, 8 heads), which both driven configurations give
    them: those of the serving configuration (lnd_impl="pallas"), then the
    separate-q/k/v attention and the caller-side-LN conv module of
    lnd_impl="xla"."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops.ln_dense import layer_norm_fp32

    f32, bf16, rows = torch.float32, torch.bfloat16, []
    b, t, d, h, k = 4, 401, 1024, 8, 9
    lengths = torch.tensor([401, 388, 200, 57], dtype=torch.int32, device=dev)
    x = rand(b, t, d, dtype=f32) + 0.5  # the fp32 residual stream
    g, beta = 1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32)

    # FFN-in: [1024, 4096] with swish; outputs |y| < ~3
    w_ffn, c_ffn = rand(d, 4 * d, scale=0.5 * d ** -0.5), rand(4 * d, scale=0.1, dtype=f32)
    args = (x, g, beta, w_ffn, c_ffn)
    rows.append(_compare("ln_dense", ops.ln_dense, ops.ln_dense_plain, args, "bf16",
                         iters=20, kwargs=dict(activation="swish"), label="FFN-in"))
    xn = layer_norm_fp32(x, g, beta).to(bf16)
    log(f"ln_dense FFN-in: the bare cuBLAS bf16 product [1604, 1024] x [1024, 4096] takes "
        f"{cuda_ms(lambda: torch.matmul(xn, w_ffn), 20):.4f} ms")
    # packed q/k/v: three [1024, 1024] segments
    w_qkv = tuple(rand(d, d, scale=0.5 * d ** -0.5) for _ in range(3))
    c_qkv = tuple(rand(d, scale=0.1, dtype=f32) for _ in range(3))
    _compare("ln_dense", ops.ln_dense, ops.ln_dense_plain, (x, g, beta, w_qkv, c_qkv), "bf16",
             iters=20, label="q/k/v")
    # the ffn1 residual add fused into the q/k/v projection
    delta = rand(b, t, d)
    rows.append(_compare("ln_dense_add", ops.ln_dense_add, ops.ln_dense_add_plain,
                         (x, delta, g, beta, w_qkv, c_qkv), ("bf16", 1e-5), iters=20,
                         kwargs=dict(scale=0.5)))
    # the block tail: fp32 LN of r + 0.5·y, ragged lengths
    rows.append(_compare("add_ln", ops.add_ln, ops.add_ln_plain, (x, delta, lengths, g, beta),
                         1e-4, iters=20, kwargs=dict(scale=0.5)))
    padded = ops.add_ln(x, delta, lengths, g, beta, scale=0.5)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    check(not padded[~valid].any().item(), "add_ln: a row past its length is not zero")
    # packed attention on [4, 401, 3072], tolerance as the separate-input check above
    qkv = rand(b, t, 3 * d, scale=0.5)
    pos = rand(2 * t - 1, h, d // h, scale=0.5)
    bu, bv = rand(h, d // h, scale=0.1, dtype=f32), rand(h, d // h, scale=0.1, dtype=f32)
    rows.append(_compare("relpos_attention_fused_packed", ops.relpos_attention_fused_packed,
                         ops.relpos_attention_fused_packed_plain,
                         (qkv, pos, bu, bv, lengths, h), 0.03, iters=20))
    # conv module with its LayerNorm inside, on the raw stream
    args = (x, lengths, rand(d, 2 * d, scale=d ** -0.5, dtype=f32),
            rand(2 * d, scale=0.1, dtype=f32), rand(k, 1, d, scale=k ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32), 1.0 + rand(d, scale=0.1, dtype=f32),
            rand(d, scale=0.1, dtype=f32), rand(d, d, scale=d ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32))
    rows.append(_compare("fused_conv_module_ln", ops.fused_conv_module,
                         ops.fused_conv_module_plain, args, 0.03, iters=20,
                         kwargs=dict(ln_scale=g, ln_bias=beta, compute_dtype=bf16)))
    # lnd_impl="xla": the same conv module on the caller's bf16 LayerNorm
    # output, and attention on separate q, k, v (tolerances as at T=376)
    rows.append(_compare("fused_conv_module", ops.fused_conv_module,
                         ops.fused_conv_module_plain, (xn,) + args[1:], 0.03, iters=20))
    q, kk, v = (rand(b, t, d, scale=0.5) for _ in range(3))
    rows.append(_compare("relpos_attention_fused", ops.relpos_attention_fused,
                         ops.relpos_attention_fused_plain, (q, kk, v, pos, bu, bv, lengths, h),
                         0.03, iters=20))
    return rows


def _compare(name, kernel, plain, args, atol, iters, kwargs=None, label=None):
    """Kernel against plain twin on the same inputs, then both timed.
    ``atol``: the max abs error allowed, "bf16" for :func:`bf16_tol`, or a
    tuple of those, one per output; ``label``: the shape, where a kernel is
    checked at more than one."""
    import torch

    kwargs = kwargs or {}
    what = f"{name} ({label})" if label else name
    got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
    torch.cuda.synchronize()
    if name == "topm_logsoftmax":  # indices must be equal, values within atol
        check(torch.equal(got[2], want[2]), f"{what}: indices differ from the plain twin")
        got, want, atol = got[:2], want[:2], (atol, atol)
    elif not isinstance(got, tuple):
        got, want, atol = (got,), (want,), (atol,)
    errs, stated = [], []
    for i, (g, w, tol) in enumerate(zip(got, want, atol)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what}[{i}]: shape/dtype")
        check(bool(torch.isfinite(g.float()).all()), f"{what}[{i}]: non-finite output")
        tol = bf16_tol(w) if tol == "bf16" else tol
        err = (g.float() - w.float()).abs().max().item()
        check(err <= tol, f"{what}[{i}]: max abs err {err} > {tol}")
        errs.append(err)
        stated.append(f"{err:.3g} (tol {tol:.3g})")
    ms = cuda_ms(lambda: kernel(*args, **kwargs), iters)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), iters)
    log(f"{what}: max_abs_err {', '.join(stated)}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms}


# --- phase 4: the main path ---------------------------------------------------


@contextlib.contextmanager
def plain_twins():
    """Run the same path with every kernel wrapper's plain twin in its place."""
    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding import rnnt_beam
    from reazonspeech_tpu_torch.models import fastconformer as fc

    targets = [(fc, name) for name in (
        "ln_dense", "ln_dense_add", "add_ln", "relpos_attention_fused",
        "relpos_attention_fused_packed", "fused_conv_module")] + [(rnnt_beam, "topm_logsoftmax")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name in targets:
        setattr(mod, name, getattr(ops, name + "_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.nemo.asr import (
        TranscribeConfig, audio_from_numpy, load_model, transcribe, transcribe_batch,
    )

    t0 = time.perf_counter()
    model = load_model(device="cuda", checkpoint="random")
    torch.cuda.synchronize()
    cfg = model.enc_cfg
    log(f"load_model: {time.perf_counter() - t0:.1f} s; {cfg.num_layers} blocks, d={cfg.d_model}, "
        f"heads={cfg.num_heads}, attn={cfg.attn_impl}, conv={cfg.conv_impl}, "
        f"lnd={cfg.lnd_impl}, {cfg.compute_dtype}/{cfg.residual_dtype}, "
        f"decode={model.decode_cfg}")
    check((cfg.d_model, cfg.num_layers, cfg.num_heads) == (1024, 24, 8), "not the xlarge width")
    check((cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl) == ("pallas",) * 3,
          "load_model on CUDA is not the serving configuration")

    batch = [audio_from_numpy(speech_like(30.0, seed=i), SR) for i in range(4)]
    long_form = audio_from_numpy(speech_like(70.0, seed=9), SR)
    transcribe_batch(model, batch[:1])  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    # the serving configuration, full depth: batch and chunked long-form
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_batch = transcribe_batch(model, batch)
    t1 = time.perf_counter()
    res_long = transcribe(model, long_form, TranscribeConfig(chunk_seconds=30.0))
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    log(f"serving configuration: launch counts {counts}")
    check(all(counts[k] > 0 for k in SERVING_KERNELS), f"a kernel was not launched: {counts}")
    check_results(res_batch, [30.0] * 4)
    check_results([res_long], [70.0])
    rate_b, rate_l = 120.0 / (t1 - t0), 70.0 / (t2 - t1)
    log(f"transcribe_batch 4 x 30 s: {t1 - t0:.3f} s wall, {rate_b:.2f} audio-s/s on {name}")
    log(f"transcribe 70 s chunked (30 s chunks): {t2 - t1:.3f} s wall, {rate_l:.2f} audio-s/s "
        f"on {name}")
    log(f"subwords: batch {[len(r.subwords) for r in res_batch]}, long {len(res_long.subwords)}")

    # the earlier configuration (separate q/k/v, caller-side LayerNorms), 4 blocks
    earlier = load_model(device="cuda", checkpoint="random", enc_cfg=FastConformerConfig.xlarge(
        num_layers=4, attn_impl="pallas", conv_impl="pallas", lnd_impl="xla",
        compute_dtype="bfloat16", residual_dtype="float32"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    check_results(transcribe_batch(earlier, batch), [30.0] * 4)
    wall = time.perf_counter() - t0
    earlier_counts = ops.launch_counts()
    log(f"lnd_impl=xla, 4 blocks: launch counts {earlier_counts}; transcribe_batch 4 x 30 s "
        f"{wall:.3f} s wall")
    check(all(earlier_counts[k] > 0 for k in EARLIER_KERNELS),
          f"a kernel of the lnd_impl=xla path was not launched: {earlier_counts}")
    del earlier

    reference_check(model)
    return {k: (counts[k] if k in SERVING_KERNELS else earlier_counts[k]) for k in counts}


def reference_check(model):
    """A short batch through the kernel path and through the same path with
    the plain twins: the encoder output agrees to bf16 noise accumulated over
    24 blocks (relative L2 <= 5e-2), and ALSD on one encoder output gives the
    same tokens with the top-m kernel as with its plain twin. Then the
    encoder at lnd_impl="xla" on the same weights, its kernels included:
    the two configurations differ only in where bf16 rounds (relative L2
    <= 5e-2)."""
    from dataclasses import replace

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
        xla_cfg = replace(model.enc_cfg, lnd_impl="xla")
        other, _ = fastconformer_encode(model.params["encoder"], feats, fl, xla_cfg)
        rel = ((enc - other) * valid).norm().item() / (other * valid).norm().item()
        log(f"encoder, lnd_impl=pallas vs lnd_impl=xla: relative L2 {rel:.3g} (tol 5e-2)")
        check(rel <= 5e-2, f"encoder lnd_impl pallas/xla relative error {rel}")
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
