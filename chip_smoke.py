#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reazonspeech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ (nvcc, sm_90a, one
   process per source, all started together);
3. kernels: each kernel against its plain PyTorch twin at the shapes the
   main paths give it, with the tolerance stated beside each check and both
   times (CUDA events after warm-up, and device time per call from
   torch.profiler): the nemo encoder kernels at the
   4 x 32 s bucket (B=4, T=401, D=1024; the lnd_impl="xla" pair also at an
   unaligned T=376), the ALSD top-m, and the Zipformer shared attention at
   the k2 shapes (stack 0 and stack 3 of a 4 x 32 s bucket, the nonlin
   applications, and the streamed entry at the 64 s bucket's T=3196); then
   the espnet shapes (12 blocks, d=512, 8 heads of dh=64): the [B, H, T, dh]
   attention's single-pass entry at the 20 s window's T=549 (B=1 and B=4)
   and its streamed entry at a 45 s input's T=1149, the layer-norm conv
   module at T=549 with and without its in-kernel pre-LN, the packed route's
   kernels at the find_blank pass's T=499, and the top-m at R=80, V=2,182;
4. nemo path: load_model(device="cuda", checkpoint="random") in its GPU
   serving configuration (lnd_impl="pallas": every encoder kernel) at the
   full xlarge width and depth (24 blocks, d=1024), transcribe_batch of
   4 x 30 s and a chunked transcribe of 70 s; then the earlier
   configuration (lnd_impl="xla", whose attention and conv kernels take
   separate q/k/v and a caller-side LayerNorm) at full width and 4 blocks
   through one transcribe_batch. Then, on a short input: the encoder and
   the ALSD decode against the same path with the plain twins in place of
   the kernels, and the encoder against the lnd_impl="xla" configuration on
   the same weights;
5. k2 path: asr.load_model(device="cuda", checkpoint="random") at the
   published reazonspeech-k2-v2 shape (ZipformerConfig.large(), full width
   and depth, attn_impl="pallas"), transcribe_batch of 4 x 30 s (every
   stack through the single-pass entry) and a transcribe of 60 s (stack 0
   past 2048 frames: the streamed entry); where the 4 x 30 s batch spends
   its time (the encoder's device busy ms, device ops and largest items,
   its CUDA-event ms and the greedy decode's, and the device busy share of
   one profiled transcribe_batch); then, on a short input, the encoder
   against the plain twins and against attn_impl="xla";
6. espnet path: espnet.asr.load_model(device="cuda", checkpoint="random") at
   the full espnet_encoder_config width and depth in its GPU serving
   configuration (every encoder kernel, bf16, fp32 residual) with Graves
   beam 20 on the top-m kernel, the joint's blank bias raised so that the
   search ends frames by ESPnet's test as a trained model does: transcribe
   of 45 s (windows at T=549, 549 and a short one, the find_blank passes on
   the packed route at T=499), decode_batch of four 20 s windows padded as
   transcribe pads them (B=4, T=549) and decode_single of 45 s (T=1149: the
   streamed entry); the mean pops per frame and the saturated count; the
   encoder's device busy ms and ops; then the encoder against the plain
   twins and against the xla impls (single-pass and streamed route), Graves
   with the top-m kernel against its twin on 100 frames, the CTC Viterbi on
   the card against the CPU's, and the lnd_impl="xla" configuration at 4
   blocks through ctc_probs (the caller-side LayerNorm conv variant);
   Launch counts are reset before and read after each path, and every
   kernel of each path must have launched;
7. the kernels' JSON line (each kernel's time, its plain twin's, the bound
   of its work on this card, the launches on its path), then the last line
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
    "shared_rel_attention": "reazonspeech_tpu/ops/zipformer_attention.py:69",
    "shared_rel_attention_blockwise": "reazonspeech_tpu/ops/zipformer_attention.py:174",
    "relpos_attention": "reazonspeech_tpu/ops/relpos_attention.py:76",
    "relpos_attention_blockwise": "reazonspeech_tpu/ops/relpos_attention.py:199",
    "fused_conv_module_layer": "reazonspeech_tpu/ops/conformer_conv.py:98",
    "fused_conv_module_ln_layer": "reazonspeech_tpu/ops/conformer_conv.py:98",
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
    "shared_rel_attention": "reazonspeech_tpu_torch/csrc/zipformer_attention.cu",
    "shared_rel_attention_blockwise": "reazonspeech_tpu_torch/csrc/zipformer_attention.cu",
    "relpos_attention": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "relpos_attention_blockwise": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "fused_conv_module_layer": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
    "fused_conv_module_ln_layer": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
}
# the kernels each configuration's encoder and decoder launch
SERVING_KERNELS = ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed",
                   "fused_conv_module_ln", "add_ln", "topm_logsoftmax")
EARLIER_KERNELS = ("relpos_attention_fused", "fused_conv_module", "topm_logsoftmax")
K2_KERNELS = ("shared_rel_attention", "shared_rel_attention_blockwise")
ESPNET_KERNELS = ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed", "add_ln",
                  "relpos_attention", "relpos_attention_blockwise", "fused_conv_module_ln_layer",
                  "topm_logsoftmax")
ESPNET_XLA_KERNELS = ("relpos_attention", "fused_conv_module_layer")
# the kernels whose JSON rows take their launches from the espnet runs
ESPNET_ROWS = ("relpos_attention", "relpos_attention_blockwise", "fused_conv_module_ln_layer",
               "fused_conv_module_layer")
# published peaks of one H100 SXM (dense, from NVIDIA's H100 datasheet):
# FLOP/s by operation type and HBM bytes/s. bound_ms is the larger of
# the bytes a call must move (each input read once, each output written
# once) over HBM_BYTES and its operations of each type over that type's
# peak (the tensor cores and the CUDA cores run side by side, so the
# times of two types are not added).
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES = 3.35e12


T0 = time.perf_counter()


def log(msg):
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


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


def device_items(fn, calls, tries=3):
    """(name, device ms, launches) of every kernel that ``calls`` calls of
    fn() run (torch.profiler, after one warm-up call), each divided by
    ``calls``. A profile that records no device kernel (the tracer drops
    one now and then) is taken again, up to ``tries`` times; then []."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        items = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if items:
            return items
    return []


def device_ms(fn, calls):
    """Device time of one fn() call in ms (every kernel it runs, summed),
    or None where the profiler recorded no kernel."""
    items = device_items(fn, calls)
    return sum(ms for _, ms, _ in items) if items else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def speech_like(seconds, seed):
    """Amplitude-modulated noise (as bench.py makes its inputs)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / SR))
    return (rng.standard_normal(n) * 0.1 * env).astype(np.float32)


# --- phase 3: kernels against their plain twins ------------------------------


def _tensors(xs):
    """The tensors in a nest of tuples/lists."""
    import torch

    if isinstance(xs, torch.Tensor):
        return [xs]
    if isinstance(xs, (tuple, list)):
        return [t for x in xs for t in _tensors(x)]
    return []


def bound_ms(flops, args, out):
    """(ms, "bytes" | "operations"): the least time the card could take for
    the call, the larger of its bytes (inputs ``args`` read once, outputs
    ``out`` written once) over the HBM rate and its operations of each type
    (``flops``, {type: count}) over that type's peak rate."""
    moved = sum(t.numel() * t.element_size() for t in _tensors(args) + _tensors(out))
    t_mem = moved / HBM_BYTES
    t_ops = max(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    return max(t_mem, t_ops) * 1e3, ("operations" if t_ops > t_mem else "bytes")


def _valid_keys(lengths, t):
    """Key positions the rows' softmax needs: Σ min(length, T)."""
    return float(lengths.clamp(max=t).sum().item())


# FLOPs of each kernel's work on its inputs (the products on the tensor
# cores as bf16, the rest on the CUDA cores as fp32)
def flops_relpos(args, out):  # q·kᵀ, the (q+v)·pos band and p·v, every head
    _, t, d = out.shape
    return {"bf16": 2.0 * t * _valid_keys(args[-2], t) * d * 3}


def flops_relpos_bhtd(args, out):  # the same three products on [B, H, T, dh]
    _, h, t, dh = out.shape
    return {"bf16": 2.0 * t * _valid_keys(args[-1], t) * h * dh * 3}


def flops_conv(args, out):  # GLU and output products, depthwise taps
    b, t, d = out.shape
    return {"bf16": 2.0 * b * t * d * 3 * d, "fp32": 2.0 * b * t * d * args[4].shape[0]}


def flops_ln_dense(args, out, w_at=3):  # the projection (the LN is bytes)
    x, w = args[0], args[w_at]
    n = sum(t.shape[1] for t in _tensors(w))
    return {"bf16": 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * n}


def flops_add_ln(args, out):  # add, two moments, normalise, affine
    return {"fp32": 8.0 * out.numel()}


def flops_topm(args, out):  # max, exp-sum and m masked argmax passes per row
    logits, m = args[0], args[1]
    return {"fp32": (3.0 + m) * logits.numel()}


def flops_shared(args, out):  # the T² products q·kᵀ, qp·pos and p·v, all bf16 operands
    q, qp, lengths = args[0], args[2], args[5]
    g, t, qd = q.shape
    keys = _valid_keys(lengths, t)
    return {"bf16": 2.0 * t * keys * (qd + qp.shape[-1] + out.shape[-1])}


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
             ops.relpos_attention_fused_plain, args, atol=0.03, iters=20, label="T=376",
             flops=flops_relpos)

    # conv module: fp32 inside both; bf16 rounding of y and of the output can
    # land one ulp apart where the fp32 sums differ in order
    w_in = rand(d, 2 * d, scale=d ** -0.5, dtype=f32)
    args = (rand(b, t, d), lengths, w_in, rand(2 * d, scale=0.1, dtype=f32),
            rand(k, 1, d, scale=k ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32),
            1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32),
            rand(d, d, scale=d ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32))
    _compare("fused_conv_module", ops.fused_conv_module, ops.fused_conv_module_plain, args,
             atol=0.03, iters=20, label="T=376", flops=flops_conv)

    # top-m: fp32 sums in another order (1e-4); indices exactly, ties included
    logits = rand(16, 3001, scale=3.0, dtype=f32)
    rows = [_compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                     (logits, 4, 3000), atol=1e-4, iters=200, flops=flops_topm)]
    ties = torch.randint(-3, 4, (16, 3001), generator=gen).to(device=dev, dtype=f32)
    got, want = ops.topm_logsoftmax(ties, 4, 3000), ops.topm_logsoftmax_plain(ties, 4, 3000)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), "topm_logsoftmax: tie order differs from the plain twin")
    log("topm_logsoftmax integer-tie case: indices equal")
    return (rows + bucket_kernel_checks(rand, dev) + shared_attention_checks(rand, dev)
            + espnet_kernel_checks(rand, dev))


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
                         iters=20, kwargs=dict(activation="swish"), label="FFN-in",
                         flops=flops_ln_dense))
    xn = layer_norm_fp32(x, g, beta).to(bf16)
    log(f"ln_dense FFN-in: the bare cuBLAS bf16 product [1604, 1024] x [1024, 4096] takes "
        f"{cuda_ms(lambda: torch.matmul(xn, w_ffn), 20):.4f} ms")
    # packed q/k/v: three [1024, 1024] segments
    w_qkv = tuple(rand(d, d, scale=0.5 * d ** -0.5) for _ in range(3))
    c_qkv = tuple(rand(d, scale=0.1, dtype=f32) for _ in range(3))
    _compare("ln_dense", ops.ln_dense, ops.ln_dense_plain, (x, g, beta, w_qkv, c_qkv), "bf16",
             iters=20, label="q/k/v", flops=flops_ln_dense)
    # the ffn1 residual add fused into the q/k/v projection
    delta = rand(b, t, d)
    rows.append(_compare("ln_dense_add", ops.ln_dense_add, ops.ln_dense_add_plain,
                         (x, delta, g, beta, w_qkv, c_qkv), ("bf16", 1e-5), iters=20,
                         kwargs=dict(scale=0.5),
                         flops=lambda a, o: flops_ln_dense(a, o, w_at=4)))
    # the block tail: fp32 LN of r + 0.5·y, ragged lengths
    rows.append(_compare("add_ln", ops.add_ln, ops.add_ln_plain, (x, delta, lengths, g, beta),
                         1e-4, iters=20, kwargs=dict(scale=0.5), flops=flops_add_ln))
    padded = ops.add_ln(x, delta, lengths, g, beta, scale=0.5)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    check(not padded[~valid].any().item(), "add_ln: a row past its length is not zero")
    # packed attention on [4, 401, 3072], tolerance as the separate-input check above
    qkv = rand(b, t, 3 * d, scale=0.5)
    pos = rand(2 * t - 1, h, d // h, scale=0.5)
    bu, bv = rand(h, d // h, scale=0.1, dtype=f32), rand(h, d // h, scale=0.1, dtype=f32)
    rows.append(_compare("relpos_attention_fused_packed", ops.relpos_attention_fused_packed,
                         ops.relpos_attention_fused_packed_plain,
                         (qkv, pos, bu, bv, lengths, h), 0.03, iters=20, flops=flops_relpos))
    # conv module with its LayerNorm inside, on the raw stream
    args = (x, lengths, rand(d, 2 * d, scale=d ** -0.5, dtype=f32),
            rand(2 * d, scale=0.1, dtype=f32), rand(k, 1, d, scale=k ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32), 1.0 + rand(d, scale=0.1, dtype=f32),
            rand(d, scale=0.1, dtype=f32), rand(d, d, scale=d ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32))
    rows.append(_compare("fused_conv_module_ln", ops.fused_conv_module,
                         ops.fused_conv_module_plain, args, 0.03, iters=20,
                         kwargs=dict(ln_scale=g, ln_bias=beta, compute_dtype=bf16),
                         flops=flops_conv))
    # lnd_impl="xla": the same conv module on the caller's bf16 LayerNorm
    # output, and attention on separate q, k, v (tolerances as at T=376)
    rows.append(_compare("fused_conv_module", ops.fused_conv_module,
                         ops.fused_conv_module_plain, (xn,) + args[1:], 0.03, iters=20,
                         flops=flops_conv))
    q, kk, v = (rand(b, t, d, scale=0.5) for _ in range(3))
    rows.append(_compare("relpos_attention_fused", ops.relpos_attention_fused,
                         ops.relpos_attention_fused_plain, (q, kk, v, pos, bu, bv, lengths, h),
                         0.03, iters=20, flops=flops_relpos))
    return rows


# Tolerance of the shared attention against its twins (fp32 out): both round
# the probabilities to bf16 at the same points (the single-pass entry after
# normalising, the streamed one per 64-key tile, the twin given block=64),
# so they differ only where an fp32 sum order or an expf ulp moves a
# probability across a bf16 rounding boundary: one bf16 ulp (<= 2^-9 of a
# probability <= 1/2) times |v| <= ~4 on a few keys.
SHARED_ATOL = 2e-3


def shared_attention_checks(rand, dev):
    """The Zipformer shared attention at the k2 main path's shapes
    (ZipformerConfig.large(): qd=32, pd=4, value head 12): per-head
    applications of stack 0 (G = 4 x 4 heads, T=1596) and stack 3 (G = 4 x 8,
    T=200) of the 4 x 32 s bucket, the nonlin applications of stack 0 (D=192:
    dv=144) and stack 3 (D=768: dv=576) with heads=1, and the streamed entry
    at the 64 s bucket's stack 0 (T=3196, one utterance: G = 4 heads, and
    its nonlin G=1, dv=144). Ragged lengths, 1 included."""
    import torch

    from reazonspeech_tpu_torch import ops

    def inputs(g, t, dv, heads, lens):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        return (rand(g, t, 32, scale=0.5), rand(g, t, 32, scale=0.5), rand(g, t, 4),
                rand(heads, 2 * t - 1, 4), rand(g, t, dv), lengths)

    def ragged(g, t):
        return [t, 1] + [max(1, t - 37 * i) for i in range(2, g)]

    single = (ops.shared_rel_attention, ops.shared_rel_attention_plain)
    rows = []
    for label, g, t, dv, heads, iters in (("stack 0", 16, 1596, 12, 4, 10),
                                          ("stack 3", 32, 200, 12, 8, 20),
                                          ("nonlin stack 0", 4, 1596, 144, 1, 10),
                                          ("nonlin stack 3", 4, 200, 576, 1, 20)):
        row = _compare("shared_rel_attention", *single, inputs(g, t, dv, heads, ragged(g, t)),
                       SHARED_ATOL, iters=iters, kwargs=dict(heads=heads), label=label,
                       flops=flops_shared)
        rows += [row] if label == "stack 0" else []
    for label, g, dv, heads in (("T=3196", 4, 12, 4), ("nonlin T=3196", 1, 144, 1)):
        row = _compare("shared_rel_attention_blockwise", ops.shared_rel_attention_blockwise,
                       ops.shared_rel_attention_blockwise_plain,
                       inputs(g, 3196, dv, heads, ragged(g, 3196) if g > 1 else [3196]),
                       SHARED_ATOL, iters=5, label=label, flops=flops_shared,
                       kwargs=dict(heads=heads), plain_kwargs=dict(block=64))
        rows += [row] if label == "T=3196" else []
    return rows


def espnet_kernel_checks(rand, dev):
    """The kernels at the espnet serving shapes (espnet_encoder_config: 8
    heads of dh=64, D=512, conv kernel 31; 2,182 tokens, beam 20): the
    [B, H, T, dh] attention at the 20 s window padded as transcribe pads it
    (22 s bucket, T=549; B=1 for transcribe, B=4 for a batch of windows) and
    at a 45 s input (46 s bucket, T=1149, the streamed entry); the
    layer-norm conv module at T=549 with the LayerNorm inside (the serving
    configuration) and by the caller; the packed route's kernels at the
    find_blank pass's T=499 (their dh=64 instantiations); the top-m over a
    batch of four's 80 pops' rows."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_blockwise, relpos_attention_blockwise_plain,
        relpos_attention_plain,
    )

    f32, bf16, rows = torch.float32, torch.bfloat16, []
    h, dh, d, k = 8, 64, 512, 31

    def bhtd(b, t, lens):
        qkv = tuple(rand(b, h, t, dh, scale=0.5) for _ in range(4))
        return (*qkv, rand(2 * t - 1, h, dh, scale=0.5),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    # fp32 out: kernel and twin round the probabilities to bf16 at the same
    # points (the single-pass entry after normalising, the streamed one per
    # 64-key tile, its twin given block=64); an fp32 sum order or an expf ulp
    # can move one across a bf16 boundary: one ulp times |v| <= ~2 on a few keys
    for label, b, lens in (("B=1, T=549", 1, [549]), ("B=4, T=549", 4, [549, 549, 520, 301])):
        row = _compare("relpos_attention", relpos_attention, relpos_attention_plain,
                       bhtd(b, 549, lens), SHARED_ATOL, iters=20, label=label,
                       flops=flops_relpos_bhtd)
        rows += [row] if b == 1 else []
    rows.append(_compare("relpos_attention_blockwise", relpos_attention_blockwise,
                         relpos_attention_blockwise_plain, bhtd(1, 1149, [1149]), SHARED_ATOL,
                         iters=10, label="B=1, T=1149", flops=flops_relpos_bhtd,
                         plain_kwargs=dict(block=64)))

    t = 549
    lengths = torch.tensor([t], dtype=torch.int32, device=dev)
    x = rand(1, t, d, dtype=f32) + 0.5  # the fp32 residual stream
    g, beta = 1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32)
    weights = (rand(d, 2 * d, scale=d ** -0.5, dtype=f32), rand(2 * d, scale=0.1, dtype=f32),
               rand(k, 1, d, scale=k ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32),
               1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32),
               rand(d, d, scale=d ** -0.5, dtype=f32), rand(d, scale=0.1, dtype=f32))
    # bf16 out, fp32 inside: as the folded forms, a few bf16 ulps
    rows.append(_compare("fused_conv_module_ln_layer", ops.fused_conv_module,
                         ops.fused_conv_module_plain, (x, lengths) + weights, 0.03, iters=20,
                         kwargs=dict(norm="layer", ln_scale=g, ln_bias=beta, compute_dtype=bf16),
                         label="T=549, D=512, K=31", flops=flops_conv))
    from reazonspeech_tpu_torch.ops.ln_dense import layer_norm_fp32

    xn = layer_norm_fp32(x, g, beta).to(bf16)
    rows.append(_compare("fused_conv_module_layer", ops.fused_conv_module,
                         ops.fused_conv_module_plain, (xn, lengths) + weights, 0.03, iters=20,
                         kwargs=dict(norm="layer"), label="T=549, D=512, K=31",
                         flops=flops_conv))

    # the packed route at T=499 (one 20 s find_blank pass): tolerances as at
    # the nemo bucket
    t = 499
    lengths = torch.tensor([t], dtype=torch.int32, device=dev)
    x = rand(1, t, d, dtype=f32) + 0.5
    w_ffn, c_ffn = rand(d, 4 * d, scale=0.5 * d ** -0.5), rand(4 * d, scale=0.1, dtype=f32)
    _compare("ln_dense", ops.ln_dense, ops.ln_dense_plain, (x, g, beta, w_ffn, c_ffn), "bf16",
             iters=20, kwargs=dict(activation="swish"), label="espnet FFN-in, T=499",
             flops=flops_ln_dense)
    w_qkv = tuple(rand(d, d, scale=0.5 * d ** -0.5) for _ in range(3))
    c_qkv = tuple(rand(d, scale=0.1, dtype=f32) for _ in range(3))
    delta = rand(1, t, d)
    _compare("ln_dense_add", ops.ln_dense_add, ops.ln_dense_add_plain,
             (x, delta, g, beta, w_qkv, c_qkv), ("bf16", 1e-5), iters=20,
             kwargs=dict(scale=0.5), label="espnet q/k/v, T=499",
             flops=lambda a, o: flops_ln_dense(a, o, w_at=4))
    _compare("add_ln", ops.add_ln, ops.add_ln_plain, (x, delta, lengths, g, beta), 1e-4,
             iters=20, kwargs=dict(scale=0.5), label="espnet, T=499", flops=flops_add_ln)
    qkv = rand(1, t, 3 * d, scale=0.5)
    pos = rand(2 * t - 1, h, dh, scale=0.5)
    bu, bv = rand(h, dh, scale=0.1, dtype=f32), rand(h, dh, scale=0.1, dtype=f32)
    _compare("relpos_attention_fused_packed", ops.relpos_attention_fused_packed,
             ops.relpos_attention_fused_packed_plain, (qkv, pos, bu, bv, lengths, h), 0.03,
             iters=20, label="espnet, dh=64, T=499", flops=flops_relpos)
    logits = rand(80, 2182, scale=3.0, dtype=f32)
    _compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
             (logits, 20, 0), 1e-4, iters=100, label="Graves, R=80, m=20, V=2182",
             flops=flops_topm)
    return rows


def _compare(name, kernel, plain, args, atol, iters, *, flops, kwargs=None, label=None,
             plain_kwargs=None):
    """Kernel against plain twin on the same inputs, then both timed.
    ``atol``: the max abs error allowed, "bf16" for :func:`bf16_tol`, or a
    tuple of those, one per output; ``label``: the shape, where a kernel is
    checked at more than one; ``flops(args, out)``: the call's operations
    for its bound; ``plain_kwargs``: extra arguments of the twin only."""
    import torch

    kwargs = kwargs or {}
    twin_kwargs = {**kwargs, **(plain_kwargs or {})}
    what = f"{name} ({label})" if label else name
    got, want = kernel(*args, **kwargs), plain(*args, **twin_kwargs)
    torch.cuda.synchronize()
    bound, bound_by = bound_ms(flops(args, got), args, got)
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
    plain_ms = cuda_ms(lambda: plain(*args, **twin_kwargs), iters)
    dev_ms = device_ms(lambda: kernel(*args, **kwargs), iters)
    plain_dev_ms = device_ms(lambda: plain(*args, **twin_kwargs), max(1, iters // 4))
    log(f"{what}: max_abs_err {', '.join(stated)}; events ms kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}; device ms kernel {fmt_ms(dev_ms)}, plain {fmt_ms(plain_dev_ms)}; "
        f"bound {bound:.4f} ms ({bound_by})")
    # library_ms: no single PyTorch call computes any of these functions on
    # these inputs (each is a chain: a norm then a product, scores with a
    # relative-position band, a log-softmax then a top-m)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


# --- phases 4 and 5: the nemo and k2 paths ------------------------------------


@contextlib.contextmanager
def plain_twins():
    """Run the same path with every kernel wrapper's plain twin in its place."""
    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding import rnnt_beam, transducer_graves
    from reazonspeech_tpu_torch.models import fastconformer as fc
    from reazonspeech_tpu_torch.models import zipformer as zf
    from reazonspeech_tpu_torch.ops.relpos_attention import (
        relpos_attention_blockwise_plain, relpos_attention_plain,
    )

    plains = {"relpos_attention": relpos_attention_plain,
              "relpos_attention_blockwise": relpos_attention_blockwise_plain}
    targets = [(fc, name) for name in (
        "ln_dense", "ln_dense_add", "add_ln", "relpos_attention_fused",
        "relpos_attention_fused_packed", "fused_conv_module", "relpos_attention",
        "relpos_attention_blockwise")]
    targets += [(rnnt_beam, "topm_logsoftmax"), (transducer_graves, "topm_logsoftmax")]
    targets += [(zf, name) for name in K2_KERNELS]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name in targets:
        setattr(mod, name, plains[name] if name in plains else getattr(ops, name + "_plain"))
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
    return {k: (counts[k] if k in SERVING_KERNELS else earlier_counts[k])
            for k in SERVING_KERNELS + EARLIER_KERNELS}


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


def check_k2_results(results, durations):
    """Text, and subwords in order on the 0.04 s grid within the padded input."""
    for r, dur in zip(results, durations):
        secs = [s.seconds for s in r.subwords]
        check(isinstance(r.text, str), "k2: text is not a string")
        check(secs == sorted(secs) and all(0 <= s <= dur + 1.8 for s in secs),
              f"k2: subword times out of order or range: {secs[:8]}")
        check(all(abs(s / 0.04 - round(s / 0.04)) < 1e-6 for s in secs),
              f"k2: subword times off the 0.04 s grid: {secs[:8]}")


def k2_path(name):
    """The k2 flavor at the published reazonspeech-k2-v2 shape: 4 x 30 s in
    one batch (the 32 s bucket: stack 0 at T=1596, single-pass entry) and a
    60 s transcribe (the 64 s bucket: stack 0 at T=3196, streamed entry)."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.k2 import asr

    t0 = time.perf_counter()
    model = asr.load_model(device="cuda", checkpoint="random")
    torch.cuda.synchronize()
    cfg = model.enc_cfg
    log(f"k2 load_model: {time.perf_counter() - t0:.1f} s; layers {cfg.num_layers}, "
        f"dims {cfg.encoder_dim}, heads {cfg.num_heads}, attn={cfg.attn_impl}, "
        f"{cfg.compute_dtype}/{cfg.residual_dtype}, predictor {model.rnnt_cfg.predictor_kind}, "
        f"vocab {model.rnnt_cfg.vocab_size}")
    large = asr.model.ZipformerConfig.large()
    check((cfg.num_layers, cfg.downsampling, cfg.encoder_dim, cfg.num_heads) ==
          (large.num_layers, large.downsampling, large.encoder_dim, large.num_heads),
          "k2: not the large width and depth")
    check((cfg.attn_impl, cfg.compute_dtype, cfg.residual_dtype) ==
          ("pallas", "bfloat16", "float32"), "k2 load_model on CUDA is not the serving config")

    batch = [asr.audio_from_numpy(speech_like(30.0, seed=30 + i), SR) for i in range(4)]
    long_form = asr.audio_from_numpy(speech_like(60.0, seed=39), SR)
    asr.transcribe_batch(model, batch[:1])  # warm-up
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_batch = asr.transcribe_batch(model, batch)
    t1 = time.perf_counter()
    res_long = asr.transcribe(model, long_form)
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    log(f"k2 path: launch counts {counts}")
    check(all(counts[k] > 0 for k in K2_KERNELS), f"a k2 kernel was not launched: {counts}")
    check_k2_results(res_batch, [30.0] * 4)
    check_k2_results([res_long], [60.0])
    log(f"k2 transcribe_batch 4 x 30 s: {t1 - t0:.3f} s wall, {120.0 / (t1 - t0):.2f} "
        f"audio-s/s on {name}")
    log(f"k2 transcribe 60 s: {t2 - t1:.3f} s wall, {60.0 / (t2 - t1):.2f} audio-s/s on {name}")
    log(f"k2 subwords: batch {[len(r.subwords) for r in res_batch]}, "
        f"long {len(res_long.subwords)}")
    k2_profile(model, batch, t1 - t0)
    k2_reference_check(model)
    return {k: counts[k] for k in K2_KERNELS}


def k2_profile(model, batch, wall_s):
    """Where the k2 4 x 30 s batch spends its time: the encoder's device
    busy ms, device ops and largest items (torch.profiler, 3 encodes), its
    CUDA-event ms (median of 5) and the greedy decode's; then the device
    busy time of one profiled transcribe_batch, over its own wall time and
    over ``wall_s``, the wall time of the unprofiled call."""
    import statistics

    import torch

    from reazonspeech_tpu_torch.decoding.rnnt_greedy import rnnt_greedy_decode
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.k2 import asr
    from reazonspeech_tpu_torch.k2.asr.transcribe import PAD_SECONDS
    from reazonspeech_tpu_torch.models.zipformer import zipformer_encode

    pad = int(PAD_SECONDS * SR)
    n = max(len(a.waveform) for a in batch) + 2 * pad
    bucket = asr.model.BUCKET_SAMPLES
    buf = np.zeros((len(batch), -(-n // bucket) * bucket), np.float32)
    for i, a in enumerate(batch):
        buf[i, pad:pad + len(a.waveform)] = a.waveform
    p = model.params
    with torch.inference_mode():
        wav = torch.from_numpy(buf).to(model.device)
        lens = torch.tensor([len(a.waveform) + 2 * pad for a in batch], dtype=torch.int32,
                            device=model.device)
        feats, fl = log_mel_spectrogram(wav, lens, model.fe_cfg)

        def encode():
            return zipformer_encode(p["encoder"], feats, fl, model.enc_cfg)

        items = device_items(encode, 3)
        enc_ms = statistics.median(cuda_ms(encode, 1, warmup=0) for _ in range(5))
        enc, el = encode()
        dec_ms = cuda_ms(lambda: rnnt_greedy_decode(p["predictor"], p["joint"], enc, el,
                                                    model.rnnt_cfg, model.decode_cfg), 1, warmup=1)
    check(items, "k2: the profiler recorded no device kernel in the encoder")
    busy = sum(ms for _, ms, _ in items)
    log(f"k2 encoder 4 x 30 s ({feats.shape[1]} fbank frames): device busy {busy:.3f} ms, "
        f"{sum(c for _, _, c in items):.0f} device ops; CUDA events {enc_ms:.3f} ms "
        f"(median of 5); greedy decode {dec_ms:.3f} ms (events)")
    for key, ms, calls in sorted(items, key=lambda x: -x[1])[:12]:
        log(f"k2 encoder item: {ms:.3f} ms x{calls:.0f} {key[:100]}")
    walls = []

    def timed_call():
        t0 = time.perf_counter()
        asr.transcribe_batch(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    busy = device_ms(timed_call, 1)  # walls: the warm-up call, then the profiled one(s)
    check(busy is not None, "k2: the profiler recorded no device kernel in transcribe_batch")
    log(f"k2 transcribe_batch 4 x 30 s: {busy:.1f} ms device busy; the device is busy "
        f"{100 * busy / (walls[-1] * 1e3):.1f} % of the profiled call ({walls[-1] * 1e3:.1f} ms "
        f"wall), {100 * busy / (wall_s * 1e3):.1f} % of the unprofiled one ({wall_s * 1e3:.1f} ms)")


def k2_reference_check(model):
    """A short batch (5 s and 3 s) through the k2 encoder: with the kernels
    against the same encoder with the plain twins, and against
    attn_impl="xla" (the materialized [B, H, T, T] weights) on the same
    weights; then the streamed entry forced at every stack against
    attn_impl="xla". bf16 compute over 19 layers: the paths differ only in
    where bf16 rounds (relative L2 <= 5e-2 on the valid frames)."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models import zipformer as zf

    wav = np.stack([speech_like(5.0, seed=40), speech_like(5.0, seed=41)])
    wav[1, 3 * SR:] = 0.0
    params = model.params["encoder"]
    with torch.inference_mode():
        w = torch.from_numpy(wav).to(model.device)
        lens = torch.tensor([5 * SR, 3 * SR], dtype=torch.int32, device=model.device)
        feats, fl = log_mel_spectrogram(w, lens, model.fe_cfg)
        enc, el = zf.zipformer_encode(params, feats, fl, model.enc_cfg)
        check(bool(torch.isfinite(enc).all()), "k2: non-finite encoder output")
        valid = (torch.arange(enc.shape[1], device=enc.device)[None, :] < el[:, None])[..., None]

        def rel_l2(a, ref):
            return ((a - ref) * valid).norm().item() / (ref * valid).norm().item()

        with plain_twins():
            twins, _ = zf.zipformer_encode(params, feats, fl, model.enc_cfg)
        xla, _ = zf.zipformer_encode(params, feats, fl, replace(model.enc_cfg, attn_impl="xla"))
        dispatch = zf._shared_attn_kernel
        zf._shared_attn_kernel = lambda t: zf.shared_rel_attention_blockwise
        try:
            streamed, _ = zf.zipformer_encode(params, feats, fl, model.enc_cfg)
        finally:
            zf._shared_attn_kernel = dispatch
    for what, a, ref in (("kernels vs plain twins", enc, twins),
                         ("attn_impl=pallas vs attn_impl=xla", enc, xla),
                         ("streamed entry forced vs attn_impl=xla", streamed, xla)):
        rel = rel_l2(a, ref)
        log(f"k2 encoder, {what}: relative L2 {rel:.3g} (tol 5e-2)")
        check(rel <= 5e-2, f"k2 encoder {what}: relative L2 {rel}")


# the espnet joint's blank logit raised on the random weights so that
# frames end by ESPnet's test as a trained model's do: the random joint's
# 2,182 logits spread little, so blank's log-prob must be within ~0.01 of 0
# for a kept hypothesis to outscore the dense cluster of pending ones
# (+8, lp_blank ~ -0.6, took 77 pops a frame against the cap of 128)
ESPNET_BLANK_BIAS = 12.0


def check_espnet_result(r, duration):
    """Text, and segments that tile it, in order, within the input."""
    check(isinstance(r.text, str), "espnet: text is not a string")
    check("".join(s.text for s in r.segments) == r.text, "espnet: segments do not tile the text")
    ends = [(s.start_seconds, s.end_seconds) for s in r.segments]
    check(all(0 <= a <= b <= duration + 1e-6 for a, b in ends), f"espnet: segments {ends[:6]}")


class PopCounter:
    """Wraps the espnet model's Graves decode with its stats form: pops,
    frames and saturated lanes summed over the calls (device tensors, read
    at the end), the host's issued pops and waits on a done flag."""

    def __init__(self, module):
        from reazonspeech_tpu_torch.decoding import transducer_graves as tg

        self.module, self.decode, self.stats = module, module.graves_beam_decode, tg
        self.ptot, self.frames, self.saturated, self.host = [], [], [], []

    def __call__(self, pp, jp, enc, elens, rnnt_cfg, cfg):
        *out, _, ptot, host = self.stats.graves_beam_decode_stats(pp, jp, enc, elens, rnnt_cfg,
                                                                  cfg)
        self.ptot.append(ptot.sum())
        self.frames.append(elens.sum())
        self.saturated.append(out[4].sum())
        self.host.append(host)
        return tuple(out)

    def __enter__(self):
        self.module.graves_beam_decode = self
        return self

    def __exit__(self, *exc):
        self.module.graves_beam_decode = self.decode

    def summary(self):
        lane_frames = sum(int(x) for x in self.frames)
        steps = sum(h["frames"] for h in self.host)
        return {"pops_per_lane_frame": sum(int(x) for x in self.ptot) / lane_frames,
                "saturated_lanes": sum(int(x) for x in self.saturated),
                "issued_per_frame": sum(h["pops_issued"] for h in self.host) / steps,
                "waits_per_frame": sum(h["waits"] for h in self.host) / steps,
                "frames": steps}


def espnet_path(name):
    """The espnet flavor at espnet_encoder_config's full width and depth in
    its GPU serving configuration, Graves beam 20: transcribe of 45 s,
    decode_batch of four 20 s windows (B=4, T=549) and decode_single of 45 s
    (T=1149)."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.transducer_graves import GravesBeamConfig
    from reazonspeech_tpu_torch.espnet import asr
    from reazonspeech_tpu_torch.espnet.asr import model as espnet_model
    from reazonspeech_tpu_torch.espnet.asr.transcribe import PADDING
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config

    t0 = time.perf_counter()
    model = asr.load_model(device="cuda", checkpoint="random")
    torch.cuda.synchronize()
    cfg = model.enc_cfg
    log(f"espnet load_model: {time.perf_counter() - t0:.1f} s; {cfg.num_layers} blocks, "
        f"d={cfg.d_model}, heads={cfg.num_heads}, conv kernel {cfg.conv_kernel}, "
        f"{cfg.subsampling_style} x{cfg.subsampling_factor}, conv_norm={cfg.conv_norm}, "
        f"attn={cfg.attn_impl}, conv={cfg.conv_impl}, lnd={cfg.lnd_impl}, "
        f"{cfg.compute_dtype}/{cfg.residual_dtype}, vocab {len(model.token_list)}, "
        f"decode={model.decode_cfg}")
    serving = replace(espnet_encoder_config(), attn_impl="pallas", conv_impl="pallas",
                      lnd_impl="pallas", compute_dtype="bfloat16", residual_dtype="float32")
    check(cfg == serving, "espnet load_model on CUDA is not the full-width serving configuration")
    check(model.decode_cfg == GravesBeamConfig(beam_size=20, topk_impl="pallas"),
          "espnet: not Graves beam 20 on the top-m kernel")
    model.params["joint"]["out"]["b"][0] += ESPNET_BLANK_BIAS

    long_form = asr.audio_from_numpy(speech_like(45.0, seed=50), SR)
    window = int(21.5 * SR)  # a 20 s window padded as transcribe pads it
    buf = np.zeros((4, 22 * SR), np.float32)
    for i in range(4):
        buf[i, :window] = np.pad(speech_like(20.0, seed=51 + i), PADDING)
    lens = np.full(4, window, np.int32)
    single = speech_like(45.0, seed=60)
    model.decode_single(speech_like(2.0, seed=49))  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    with PopCounter(espnet_model) as pops:
        t0 = time.perf_counter()
        res = asr.transcribe(model, long_form, asr.TranscribeConfig(verbose=False))
        t1 = time.perf_counter()
        batch = model.decode_batch(buf, lens)
        t2 = time.perf_counter()
        tokens, frames = model.decode_single(single)
        t3 = time.perf_counter()
    counts = ops.launch_counts()
    log(f"espnet path: launch counts {counts}")
    check(all(counts[k] > 0 for k in ESPNET_KERNELS),
          f"an espnet kernel was not launched: {counts}")
    check_espnet_result(res, 45.0)
    # 21.5 s of valid samples in the 22 s bucket: 537 valid of T=549 frames
    check(batch[3].tolist() == [537] * 4, f"espnet decode_batch: encoder lengths {batch[3]}")
    check(frames == sorted(frames) and all(0 <= f < 1149 for f in frames),
          "espnet decode_single: emission frames out of order or range")
    log(f"espnet transcribe 45 s: {t1 - t0:.3f} s wall, {45.0 / (t1 - t0):.2f} audio-s/s "
        f"on {name}; {len(res.text)} characters, {len(res.segments)} segments")
    log(f"espnet decode_batch 4 x 20 s windows (B=4, T=549): {t2 - t1:.3f} s wall, "
        f"{80.0 / (t2 - t1):.2f} audio-s/s; tokens {batch[2].tolist()}")
    log(f"espnet decode_single 45 s (T=1149): {t3 - t2:.3f} s wall, {45.0 / (t3 - t2):.2f} "
        f"audio-s/s; {len(tokens)} tokens")
    from reazonspeech_tpu_torch.espnet.asr.ctc import find_blank

    blank = find_blank(model, long_form.waveform[:20 * SR])
    log(f"espnet first window: longest CTC blank run {tuple(blank)} of {20 * SR} samples "
        f"(the sentinel ({20 * SR}, {20 * SR}) when none passes 0.98: a cut at 20 s)")
    stats = pops.summary()
    log(f"espnet Graves beam {model.decode_cfg.beam_size}: "
        f"{stats['pops_per_lane_frame']:.2f} pops per lane-frame, "
        f"{stats['issued_per_frame']:.2f} pops issued per frame step, "
        f"{stats['waits_per_frame']:.3f} host waits on a done flag per frame step "
        f"({stats['frames']} frame steps); saturated lanes {stats['saturated_lanes']}")
    espnet_profile(model, buf, lens)
    espnet_reference_check(model, buf, lens, single)
    out = {k: counts[k] for k in ESPNET_ROWS if k != "fused_conv_module_layer"}
    out["fused_conv_module_layer"] = espnet_xla_config(buf[:1], lens[:1])
    return out


def _espnet_encode(model, wav, lens, enc_cfg=None):
    """frontend → GlobalMVN → encoder on host arrays; returns (enc, enc_lengths)."""
    import torch

    from reazonspeech_tpu_torch.espnet.asr.model import _encode

    w = torch.from_numpy(np.ascontiguousarray(wav)).to(model.device)
    lengths = torch.from_numpy(np.asarray(lens, np.int32)).to(model.device)
    return _encode(model.params, w, lengths, model.fe_cfg, enc_cfg or model.enc_cfg)


def espnet_profile(model, buf, lens):
    """Where the B=4, T=549 batch's encoder spends its time: device busy ms,
    ops and largest items (torch.profiler, 3 encodes) and its CUDA-event ms
    (median of 5). A decode_batch is not profiled: the Graves loop's ~1.4
    million launches a call take the profiler many minutes to reduce."""
    import statistics

    import torch

    with torch.inference_mode():
        def encode():
            return _espnet_encode(model, buf, lens)

        items = device_items(encode, 3)
        enc_ms = statistics.median(cuda_ms(encode, 1, warmup=0) for _ in range(5))
    check(items, "espnet: the profiler recorded no device kernel in the encoder")
    busy = sum(ms for _, ms, _ in items)
    log(f"espnet encoder B=4, T=549: device busy {busy:.3f} ms, "
        f"{sum(c for _, _, c in items):.0f} device ops; CUDA events {enc_ms:.3f} ms "
        f"(median of 5)")
    for key, ms, calls in sorted(items, key=lambda x: -x[1])[:12]:
        log(f"espnet encoder item: {ms:.3f} ms x{calls:.0f} {key[:100]}")


def espnet_reference_check(model, buf, lens, single):
    """The B=4, T=549 batch (single-pass route) and the 45 s input (T=1149,
    streamed route) through the espnet encoder with the kernels, against the
    same encoder with the plain twins and against the xla impls on the same
    weights: bf16 compute over 12 blocks, the paths differ only in where bf16
    rounds (relative L2 <= 5e-2 on the valid frames). Then Graves beam 20 on
    the batch's first 100 encoder frames gives the same tokens, frames and
    counts with the top-m kernel as with its plain twin, and the CTC Viterbi
    forward pass on the card gives the same alignment as on the CPU."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch.decoding.ctc import ctc_viterbi_align
    from reazonspeech_tpu_torch.decoding.transducer_graves import graves_beam_decode
    from reazonspeech_tpu_torch.models.conformer import ctc_log_softmax

    xla_cfg = replace(model.enc_cfg, attn_impl="xla", conv_impl="xla", lnd_impl="xla")
    n = 46 * SR
    wav1 = np.zeros((1, n), np.float32)
    wav1[0, :len(single)] = single
    with torch.inference_mode():
        for label, wav, lengths in (("B=4, T=549", buf, lens),
                                    ("B=1, T=1149", wav1, [len(single)])):
            enc, el = _espnet_encode(model, wav, lengths)
            check(bool(torch.isfinite(enc).all()), "espnet: non-finite encoder output")
            frame = torch.arange(enc.shape[1], device=enc.device)
            valid = (frame[None, :] < el[:, None])[..., None]
            with plain_twins():
                twins, _ = _espnet_encode(model, wav, lengths)
            xla, _ = _espnet_encode(model, wav, lengths, xla_cfg)
            for what, ref in (("kernels vs plain twins", twins), ("kernels vs xla impls", xla)):
                rel = ((enc - ref) * valid).norm().item() / (ref * valid).norm().item()
                log(f"espnet encoder {label}, {what}: relative L2 {rel:.3g} (tol 5e-2)")
                check(rel <= 5e-2, f"espnet encoder {label} {what}: relative L2 {rel}")
            if label.startswith("B=4"):
                p, head = model.params, (enc[:, :100], el.clamp(max=100))
                got = graves_beam_decode(p["predictor"], p["joint"], *head, model.rnnt_cfg,
                                         model.decode_cfg)
                with plain_twins():
                    want = graves_beam_decode(p["predictor"], p["joint"], *head,
                                              model.rnnt_cfg, model.decode_cfg)
                lpz_log = ctc_log_softmax(p["ctc"], enc[0, :int(el[0])])
    for g, w_, what in zip(got[:3], want[:3], ("tokens", "frames", "counts")):
        check(torch.equal(g, w_), f"Graves {what} differ between the top-m kernel and its twin")
    log(f"Graves beam 20, 100 frames, with the top-m kernel == with its plain twin: "
        f"counts {got[2].tolist()}")
    ids = np.random.default_rng(61).integers(1, lpz_log.shape[1] - 1, 60)
    on_card = ctc_viterbi_align(lpz_log, ids)
    check(np.array_equal(on_card, ctc_viterbi_align(lpz_log.cpu(), ids)) and len(on_card) == 60,
          "CTC Viterbi: the card's alignment differs from the CPU's")
    log(f"CTC Viterbi of 60 tokens over {lpz_log.shape[0]} frames: the card's path == the CPU's")


def espnet_xla_config(buf, lens):
    """The espnet lnd_impl="xla" configuration at full width and 4 blocks
    (the attention and conv kernels, caller-side LayerNorms) through
    ctc_probs of one padded 20 s window (the 22 s bucket, T=549): the
    [B, H, T, dh] route and the layer-norm conv module's caller-LN variant.
    Returns the latter's launches."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.espnet import asr
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config

    model = asr.load_model(device="cuda", checkpoint="random", enc_cfg=espnet_encoder_config(
        num_layers=4, attn_impl="pallas", conv_impl="pallas", lnd_impl="xla",
        compute_dtype="bfloat16", residual_dtype="float32"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lpz = model.ctc_probs(buf[0, :int(lens[0])])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"espnet lnd_impl=xla, 4 blocks: launch counts {counts}; ctc_probs of one 20 s "
        f"window {time.perf_counter() - t0:.3f} s wall, lpz {lpz.shape}")
    check(np.isfinite(lpz).all() and np.allclose(lpz.sum(-1), 1.0, atol=1e-3),
          "espnet lnd_impl=xla: CTC probabilities do not sum to 1")
    check(all(counts[k] > 0 for k in ESPNET_XLA_KERNELS),
          f"a kernel of the espnet lnd_impl=xla path was not launched: {counts}")
    return counts["fused_conv_module_layer"]


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
    counts.update(k2_path(f"{smi}"))
    counts.update(espnet_path(f"{smi}"))
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
