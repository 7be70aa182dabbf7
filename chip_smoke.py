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
   then the beam decoders' step kernels in fp32: the fused joint + top-m at
   nemo ALSD's, espnet Graves' and k2 ALSD's shapes and on exact ties, and
   the LSTM cell at nemo's and espnet's predictors and at nemo ALSD beam 40
   x 4 lanes (R = 160) beside torch.lstm_cell;
   then the top-m and step kernels past their former size caps (m = 40,
   V = 50,000, H = J = 3,072, H_in = H = 1,536). The top-m (row 3) is
   also timed beside torch.amax over the same logits (one reduction over
   the same bytes) and must run as one device kernel a call at every V
   (V = 3,001, 2,182 and 50,000); the fused joint (row 12) beside the bare
   fp32 cuBLAS products dec.Wp and z.Wo, with its device kernels a call (at
   most two: no merge launch) and its span from the first kernel's start
   to the last one's end beside the summed device ms: yardsticks, never
   called by the port, and not the same functions. Then every
   rel-pos entry at head widths past the published models' (dh = 8, 36,
   44, 80, 96, 256) and both shared-attention entries at (qd, pd) = (64, 4), (12, 9),
   (48, 16) and (128, 32). The packed attention at nemo's bucket and the
   single-pass entry at espnet's window are also timed beside torch's
   scaled_dot_product_attention on the same q+u, k and v with the shifted
   position term and the length mask as a precomputed float mask (not the
   same function; a yardstick the port never calls). The LayerNorm-fused
   projections (rows 4-5) and the conv module (row 2, at nemo's and
   espnet's shapes) are also timed with their GEMMs' column tile forced to
   128 and to 256, beside the bare cuBLAS bf16 products on the same
   operands (a yardstick; the port never calls it);
4. nemo path: load_model(device="cuda", checkpoint="random") in its GPU
   serving configuration (lnd_impl="pallas": every encoder kernel) at the
   full xlarge width and depth (24 blocks, d=1024), transcribe_batch of
   4 x 30 s and a chunked transcribe of 70 s; then the earlier
   configuration (lnd_impl="xla", whose attention and conv kernels take
   separate q/k/v and a caller-side LayerNorm) at full width and 4 blocks
   through one transcribe_batch; then where the 4 x 30 s encoder spends its
   device time at full depth on the same weights in both lnd_impl
   configurations (device busy ms, device ops, the largest items, CUDA-event
   ms; each must have launched its kernels). Then, on a short input: the
   encoder and the ALSD decode against the same path with the plain twins in
   place of the kernels, and the encoder against the lnd_impl="xla"
   configuration on the same weights; then load_model(beam_size=40) (m = 40
   label expansions a hypothesis on the top-m kernel) through a 5 s
   transcribe, its tokens against the same decode with the top-m twin;
   then a 4-block encoder of d_model = 176 and 4 heads (dh = 44: the
   generic route) on a short batch against its plain-twin path;
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
7. the beam decoders' step kernels (rows 12-13: joint_impl and
   lstm_impl="pallas", off by default in every loader): after the nemo
   path, load_model(decode_cfg=BeamDecodeConfig(... joint_impl="pallas",
   lstm_impl="pallas")) at the xlarge width and depth, transcribe_batch of
   4 x 30 s, then the device launches and host ms per ALSD step with and
   without the switches; after the k2 path, load_model_container(
   decoding="beam") at ZipformerConfig.large() with joint_impl="pallas",
   transcribe_batch of 4 x 30 s; in the espnet path, decode_batch of the
   four 20 s windows with both switches, pops per lane-frame, ms and
   device launches per issued pop with and without them (the joint is two
   device launches a call, the top-m one). Each runs again
   with the two kernels' plain twins: the tokens must be equal, or else the
   first differing step's two candidates must lie within 1e-4 in fp32 (a
   near-tie the two summation orders break differently);
8. the kernels' JSON line (each kernel's time, its plain twin's, the bound
   of its work on this card, the launches on its path, and the time of one
   PyTorch call computing the same function where there is one), then the
   last line {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

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
    "joint_topm": "reazonspeech_tpu/ops/beam_topk.py:152",
    "lstm_cell_step": "reazonspeech_tpu/ops/lstm_step.py:67",
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
    "joint_topm": "reazonspeech_tpu_torch/csrc/joint_topm.cu",
    "lstm_cell_step": "reazonspeech_tpu_torch/csrc/lstm_step.cu",
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
# the beam decoders' opt-in step kernels (joint_impl/lstm_impl="pallas")
STEP_KERNELS = ("joint_topm", "lstm_cell_step")
# the kernels whose JSON rows take their launches from the espnet runs
ESPNET_ROWS = ("relpos_attention", "relpos_attention_blockwise", "fused_conv_module_ln_layer",
               "fused_conv_module_layer")
# published peaks of one H100 SXM (dense, from NVIDIA's H100 datasheet):
# FLOP/s by operation type and HBM bytes/s; "exp", the exponentials of a
# softmax, at the special-function units' 16 a clock on each of the 132
# SMs at the 1.98 GHz boost clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0). bound_ms is the larger
# of the bytes a call must move (each input read once, each output written
# once) over HBM_BYTES and its operations of each type over that type's
# peak (the tensor cores, the CUDA cores and the special-function units run
# side by side, so the times of two types are not added).
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "exp": 132 * 16 * 1.98e9}
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


def device_calls(fn, calls, name):
    """(device kernels named ``*name*`` a call, device span of a call in
    ms): torch.profiler over ``calls`` calls of fn() after a warm-up; the
    span runs from a call's first kernel start to its last kernel end, the
    median over the calls. (0, None) where the profiler recorded no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and name in e.name)
        if ks and len(ks) % calls == 0:
            n = len(ks) // calls
            spans = sorted(max(e for _, e in ks[i:i + n]) - ks[i][0] for i in range(0, len(ks), n))
            return n, spans[len(spans) // 2] / 1e3
    return 0, None


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


def _valid_scores(lengths, t):
    """Scores a softmax row set needs: Σ min(length, T)², the valid query
    rows times the valid keys (rows past a length are garbage the caller
    masks, so the function needs none of their work)."""
    return float(lengths.clamp(max=t).double().square().sum().item())


# FLOPs of each kernel's work on its inputs (the products on the tensor
# cores as bf16, the rest on the CUDA cores as fp32, and one exponential a
# valid score of a softmax)
def flops_relpos(args, out):  # q·kᵀ, the (q+v)·pos band and p·v, every head
    d, h = out.shape[-1], args[-1]
    scores = _valid_scores(args[-2], out.shape[1])
    return {"bf16": 2.0 * scores * d * 3, "exp": scores * h}


def flops_relpos_bhtd(args, out):  # the same three products on [B, H, T, dh]
    _, h, t, dh = out.shape
    scores = _valid_scores(args[-1], t)
    return {"bf16": 2.0 * scores * h * dh * 3, "exp": scores * h}


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


def flops_joint(args, out):  # both joint products, then the top-m passes over [R, V]
    w_pred, w_out, enc, m = args[0], args[2], args[4], args[6]
    (h, j), v, r = w_pred.shape, w_out.shape[1], enc.shape[0]
    return {"fp32": 2.0 * r * j * (h + v) + (3.0 + m) * r * v}


def flops_lstm(args, out):  # the gate products, then ~10 operations an element of c'
    w_ih, w_hh, x = args[0], args[1], args[3]
    return {"fp32": 2.0 * x.shape[0] * (w_ih.shape[0] + w_hh.shape[0]) * w_ih.shape[1]
            + 10.0 * out[1].numel()}


def flops_shared(args, out):  # the T² products q·kᵀ, qp·pos and p·v, all bf16 operands
    q, qp, lengths = args[0], args[2], args[5]
    scores = _valid_scores(lengths, q.shape[1])
    return {"bf16": 2.0 * scores * (q.shape[2] + qp.shape[-1] + out.shape[-1]), "exp": scores}


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
    topm_yardstick(rows[-1], "nemo ALSD, R=16, V=3001, m=4", logits, 4, 3000)
    ties = torch.randint(-3, 4, (16, 3001), generator=gen).to(device=dev, dtype=f32)
    got, want = ops.topm_logsoftmax(ties, 4, 3000), ops.topm_logsoftmax_plain(ties, 4, 3000)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), "topm_logsoftmax: tie order differs from the plain twin")
    log("topm_logsoftmax integer-tie case: indices equal")
    rows += bucket_kernel_checks(rand, dev) + shared_attention_checks(rand, dev)
    rows += espnet_kernel_checks(rand, dev) + step_kernel_checks(rand, dev)
    wide_kernel_checks(rand, dev)
    head_width_checks(rand, dev)
    return rows


def topm_yardstick(row, label, logits, m, blank):
    """Row 3 beside torch.amax over the same logits (one PyTorch reduction
    reading the same bytes: the floor of any one-launch read of the rows;
    not the same function, and the port never calls it), events and device
    ms into ``row["amax_ms"]`` and the log; and one device kernel a call."""
    import torch

    from reazonspeech_tpu_torch import ops

    def amax():
        return torch.amax(logits, dim=-1)

    row["amax_ms"] = cuda_ms(amax, 200)
    n, _ = device_calls(lambda: ops.topm_logsoftmax(logits, m, blank), 20, "topm_kernel")
    log(f"topm_logsoftmax ({label}): torch.amax over the same logits (a yardstick, not the same "
        f"function): events ms {row['amax_ms']:.4f}, device ms {fmt_ms(device_ms(amax, 200))}; "
        f"the kernel's device ms {fmt_ms(row['device_ms'])}; {n} device kernel(s) a call")
    check(n == 1, f"topm_logsoftmax ({label}): {n} device kernels a call, not one")


def joint_yardstick(row, label, args, act):
    """Row 12 beside the bare fp32 cuBLAS products dec·Wp and z·Wo on the
    same operands (TF32 off; a yardstick the port never calls: the kernel
    also applies the activation, the log-softmax and the top-m), events and
    device ms into ``row["cublas_ms"]`` and the log; the kernel's device
    kernels a call (at most two) and its span beside its summed device ms."""
    import torch

    from reazonspeech_tpu_torch import ops

    w_pred, b_pred, w_out, _, enc, dec, m, blank = args
    acts = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    z = acts[act](enc + (dec @ w_pred + b_pred))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def cublas():
            torch.matmul(dec, w_pred)
            torch.matmul(z, w_out)

        row["cublas_ms"] = cuda_ms(cublas, 200)
        cublas_dev = device_ms(cublas, 200)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    n, span = device_calls(lambda: ops.joint_topm(*args, activation=act, compute_dtype="float32"),
                           20, "joint_")
    row["span_ms"] = span
    log(f"joint_topm ({label}): the bare fp32 cuBLAS products dec.Wp and z.Wo (a yardstick, "
        f"not the same function): events ms {row['cublas_ms']:.4f}, device ms "
        f"{fmt_ms(cublas_dev)}; the kernel: {n} device kernels a call, device ms summed "
        f"{fmt_ms(row['device_ms'])}, span (first start to last end) {fmt_ms(span)}")
    check(0 < n <= 2, f"joint_topm ({label}): {n} device kernels a call, not at most two")


def bf16_tol(want):
    """2 bf16 ulps at the largest |value|: the kernel and the twin round at
    the same points, only their fp32 sums differ in order."""
    return 2.0 * 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)


def gemm_yardstick(row, label, products, call):
    """A GEMM-based kernel beside the bare cuBLAS bf16 products on the same
    operands (``products``, pairs (a, w): rows 4-5's one product, the q/k/v
    segments concatenated once outside the timing; row 2's x·w_in and
    y·w_out), by CUDA events and by profiler device time, into
    ``row["cublas_ms"]`` (events) and the log with the ratio the kernel's
    device time bears to them; then the kernel (``call()``) with its GEMMs'
    column tile forced to 128 and to 256, device and events ms."""
    import torch

    from reazonspeech_tpu_torch.ops._kernels import forced_tile_n

    def cublas():
        for a, w in products:
            torch.matmul(a, w)

    row["cublas_ms"] = cuda_ms(cublas, 20)
    dev_ms = device_ms(cublas, 20)
    ratio = "not measured" if dev_ms is None or row["device_ms"] is None else \
        f"{row['device_ms'] / dev_ms:.2f}x"
    shapes = " + ".join(f"{tuple(a.shape)} x {tuple(w.shape)}" for a, w in products)
    log(f"{row['name']} ({label}): the bare cuBLAS bf16 product(s) {shapes}: events ms "
        f"{row['cublas_ms']:.4f}, device ms {fmt_ms(dev_ms)}; the kernel's device ms "
        f"{fmt_ms(row['device_ms'])} is {ratio} it (bar 2x)")
    for tile_n in (128, 256):
        with forced_tile_n(tile_n):
            log(f"{row['name']} ({label}), GEMM column tile forced to {tile_n}: device ms "
                f"{fmt_ms(device_ms(call, 20))}, events ms {cuda_ms(call, 20):.4f}")


def conv_yardstick(row, label, x, args, kwargs):
    """Row 2 beside the bare cuBLAS products x·w_in and y·w_out (bf16: x the
    module input, LayerNormed where the kernel normalizes it; y a random
    tensor of the depthwise output's shape, as a product's time does not
    depend on the values), and with both products' column tile forced."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops.ln_dense import layer_norm_fp32

    bf16 = torch.bfloat16
    xn = x if "ln_scale" not in kwargs else \
        layer_norm_fp32(x, kwargs["ln_scale"], kwargs["ln_bias"]).to(bf16)
    w_in, w_out = args[2].to(bf16), args[8].to(bf16)
    y = torch.randn(xn.shape, device=xn.device).to(bf16)

    gemm_yardstick(row, label, [(xn, w_in), (y, w_out)],
                   lambda: ops.fused_conv_module(x, *args[1:], **kwargs))


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
    gemm_yardstick(rows[-1], "FFN-in", [(xn, w_ffn)],
                   lambda: ops.ln_dense(x, g, beta, w_ffn, c_ffn, activation="swish"))
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
    gemm_yardstick(rows[-1], "q/k/v", [(xn, torch.cat(w_qkv, dim=1))],
                   lambda: ops.ln_dense_add(x, delta, g, beta, w_qkv, c_qkv, scale=0.5))
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
    heads_first = lambda x: x.reshape(b, t, h, d // h).transpose(1, 2)  # noqa: E731
    q = heads_first(qkv[..., :d])
    sdpa_yardstick(rows[-1], "T=401", q + bu.to(bf16)[:, None], q + bv.to(bf16)[:, None],
                   heads_first(qkv[..., d:2 * d]), heads_first(qkv[..., 2 * d:]), pos, lengths)
    # conv module with its LayerNorm inside, on the raw stream
    args = (x, lengths, rand(d, 2 * d, scale=d ** -0.5, dtype=f32),
            rand(2 * d, scale=0.1, dtype=f32), rand(k, 1, d, scale=k ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32), 1.0 + rand(d, scale=0.1, dtype=f32),
            rand(d, scale=0.1, dtype=f32), rand(d, d, scale=d ** -0.5, dtype=f32),
            rand(d, scale=0.1, dtype=f32))
    conv_kw = dict(ln_scale=g, ln_bias=beta, compute_dtype=bf16)
    rows.append(_compare("fused_conv_module_ln", ops.fused_conv_module,
                         ops.fused_conv_module_plain, args, 0.03, iters=20, kwargs=conv_kw,
                         flops=flops_conv))
    conv_yardstick(rows[-1], "T=401", x, args, conv_kw)
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
        args = inputs(g, t, dv, heads, ragged(g, t))
        row = _compare("shared_rel_attention", *single, args, SHARED_ATOL, iters=iters,
                       kwargs=dict(heads=heads), label=label, flops=flops_shared)
        rows += [row] if label == "stack 0" else []
    for label, g, dv, heads in (("T=3196", 4, 12, 4), ("nonlin T=3196", 1, 144, 1)):
        args = inputs(g, 3196, dv, heads, ragged(g, 3196) if g > 1 else [3196])
        row = _compare("shared_rel_attention_blockwise", ops.shared_rel_attention_blockwise,
                       ops.shared_rel_attention_blockwise_plain, args, SHARED_ATOL, iters=5,
                       label=label, flops=flops_shared, kwargs=dict(heads=heads),
                       plain_kwargs=dict(block=64))
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
        args = bhtd(b, 549, lens)
        row = _compare("relpos_attention", relpos_attention, relpos_attention_plain, args,
                       SHARED_ATOL, iters=20, label=label, flops=flops_relpos_bhtd)
        if b == 1:
            rows.append(row)
            qu, qv, kk, v, pos, lengths = args
            sdpa_yardstick(row, label, qu, qv, kk, v, pos, lengths)
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
    conv_kw = dict(norm="layer", ln_scale=g, ln_bias=beta, compute_dtype=bf16)
    rows.append(_compare("fused_conv_module_ln_layer", ops.fused_conv_module,
                         ops.fused_conv_module_plain, (x, lengths) + weights, 0.03, iters=20,
                         kwargs=conv_kw, label="T=549, D=512, K=31", flops=flops_conv))
    conv_yardstick(rows[-1], "T=549, D=512, K=31", x, (x, lengths) + weights, conv_kw)
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
    row = _compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                   (logits, 20, 0), 1e-4, iters=100, label="Graves, R=80, m=20, V=2182",
                   flops=flops_topm)
    topm_yardstick(row, "Graves, R=80, V=2182, m=20", logits, 20, 0)
    return rows


def step_kernel_checks(rand, dev):
    """The beam decoders' step kernels at the shapes their paths give them
    (fp32, as the decoders call them): the fused joint + top-m (row 12) at
    nemo ALSD (R = 4 lanes x beam 4, H = J = 640, V = 3,001, blank last,
    relu, m = 4), espnet Graves (R = 4 lanes, H = J = 256, V = 2,182, blank
    first, tanh, m = beam 20) and k2 ALSD (R = 16, H = J = 512, V = 2,179,
    blank first, tanh, m = 4), and on exact ties; the LSTM cell (row 13) at
    nemo's (R = 16, H = 640) and espnet's (R = 4, H = 256) predictors and at
    nemo ALSD beam 40 x 4 lanes (R = 160, H = 640), each with its bound and
    torch.lstm_cell (weights as [4H, in]) timed beside it, and one device
    kernel a call."""
    import torch

    from reazonspeech_tpu_torch import ops

    f32, rows = torch.float32, []
    # fp32 both, the sums in another order (tiles of 32 columns, 8 slices of
    # the depth): 1e-5 on log-probs of |.| < ~20; indices exactly
    for label, r, h, v, blank, act, m in (("nemo ALSD", 16, 640, 3001, 3000, "relu", 4),
                                          ("espnet Graves", 4, 256, 2182, 0, "tanh", 20),
                                          ("k2 ALSD", 16, 512, 2179, 0, "tanh", 4)):
        args = _joint_args(rand, r, h, v, blank, act, m)
        row = _compare("joint_topm", ops.joint_topm, ops.joint_topm_plain, args, 1e-5, iters=200,
                       kwargs=dict(activation=act, compute_dtype="float32"),
                       label=f"{label}, R={r}, H=J={h}, V={v}, m={m}", flops=flops_joint)
        joint_yardstick(row, label, args, act)
        rows += [row] if label == "nemo ALSD" else []
        if label == "espnet Graves":  # a zero output projection: logits = integer b_out
            tied = (*args[:2], torch.zeros_like(args[2]),
                    torch.randint(-3, 4, (v,), device=dev).to(f32), *args[4:])
            got = ops.joint_topm(*tied, activation=act, compute_dtype="float32")
            want = ops.joint_topm_plain(*tied, activation=act, compute_dtype="float32")
            torch.cuda.synchronize()
            check(torch.equal(got[2], want[2]), "joint_topm: tie order differs from the twin")
            log("joint_topm integer-tie case (m=20): indices equal")
    for label, r, h in (("nemo ALSD", 16, 640), ("espnet Graves", 4, 256),
                        ("nemo ALSD beam 40 x 4 lanes", 160, 640)):
        w_ih, w_hh = rand(h, 4 * h, scale=h ** -0.5, dtype=f32), rand(h, 4 * h, scale=h ** -0.5,
                                                                      dtype=f32)
        bias, x = rand(4 * h, scale=0.1, dtype=f32), rand(r, h, dtype=f32)
        hp, cp = rand(r, h, scale=0.5, dtype=f32), rand(r, h, dtype=f32)
        w_ih_t, w_hh_t, zero = w_ih.t().contiguous(), w_hh.t().contiguous(), torch.zeros_like(bias)
        row = _compare("lstm_cell_step", ops.lstm_cell_step, ops.lstm_cell_step_plain,
                       (w_ih, w_hh, bias, x, hp, cp), (1e-5, 1e-5), iters=200,
                       kwargs=dict(compute_dtype="float32"), label=f"{label}, R={r}, H={h}",
                       flops=flops_lstm,
                       library=lambda: torch.lstm_cell(x, (hp, cp), w_ih_t, w_hh_t, bias, zero))
        n, _ = device_calls(lambda: ops.lstm_cell_step(w_ih, w_hh, bias, x, hp, cp,
                                                       compute_dtype="float32"), 20, "lstm_cell")
        log(f"lstm_cell_step ({label}, R={r}, H={h}): {n} device kernel(s) a call")
        check(n == 1, f"lstm_cell_step ({label}): {n} device kernels a call, not one")
        rows += [row] if label == "nemo ALSD" else []
    return rows


def _joint_args(rand, r, h, v, blank, act, m):
    """fp32 inputs of joint_topm at H = J = h, redrawn until the m + 1 best
    labels of every row are 1e-5 apart in float64: no near-tie that two fp32
    summation orders could break differently, so the picks must be equal."""
    import torch

    f32 = torch.float32
    acts = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    while True:
        args = (rand(h, h, scale=h ** -0.5, dtype=f32), rand(h, scale=0.1, dtype=f32),
                rand(h, v, scale=h ** -0.5, dtype=f32), rand(v, scale=0.1, dtype=f32),
                rand(r, h, dtype=f32), rand(r, h, dtype=f32))
        wp, bp, wo, bo, enc, dec = (a.double() for a in args)
        logits = acts[act](enc + (dec @ wp + bp)) @ wo + bo
        logits[:, blank] = -1e30
        best = logits.topk(m + 1, dim=1).values
        if (best[:, :-1] - best[:, 1:]).min() > 1e-5:
            return args + (m, blank)


def wide_kernel_checks(rand, dev):
    """The top-m kernel (row 3), the fused joint (row 12) and the LSTM cell
    (row 13) at shapes past their former caps (m <= 32, V <= 49,152, a
    depth of at most 3,000), tolerances as at the paths' shapes: the top-m
    at m = 40 on nemo's V and at V = 50,000 (seven tiles and the merge
    launch), the joint at m = 40 and V = 50,000 and at H = J = 3,072, the
    LSTM cell at H_in = H = 1,536 (the depth in two chunks). Logged only."""
    import torch

    from reazonspeech_tpu_torch import ops

    f32 = torch.float32
    for label, r, v, m, blank in (("R=16, V=3001, m=40", 16, 3001, 40, 3000),
                                  ("R=4, V=50000, m=40", 4, 50000, 40, 0)):
        logits = rand(r, v, scale=3.0, dtype=f32)
        row = _compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                       (logits, m, blank), 1e-4, iters=20, label=label, flops=flops_topm)
        topm_yardstick(row, label, logits, m, blank)
    for label, r, h, v, m in (("R=16, H=J=640, V=50000, m=40", 16, 640, 50000, 40),
                              ("R=16, H=J=3072, V=3001, m=4", 16, 3072, 3001, 4)):
        _compare("joint_topm", ops.joint_topm, ops.joint_topm_plain,
                 _joint_args(rand, r, h, v, v - 1, "relu", m), 1e-5, iters=20,
                 kwargs=dict(activation="relu", compute_dtype="float32"), label=label,
                 flops=flops_joint)
    r, h = 16, 1536
    w_ih, w_hh = (rand(h, 4 * h, scale=h ** -0.5, dtype=f32) for _ in range(2))
    args = (w_ih, w_hh, rand(4 * h, scale=0.1, dtype=f32), rand(r, h, dtype=f32),
            rand(r, h, scale=0.5, dtype=f32), rand(r, h, dtype=f32))
    _compare("lstm_cell_step", ops.lstm_cell_step, ops.lstm_cell_step_plain, args,
             (1e-5, 1e-5), iters=20, kwargs=dict(compute_dtype="float32"),
             label="R=16, H_in=H=1536", flops=flops_lstm)


def sdpa_yardstick(row, label, qu, qv, k, v, pos, lengths):
    """torch's scaled_dot_product_attention on the same q+u, k and v
    ([B, H, T, dh] bf16), given the shifted position term (q+v)·posᵀ, scaled,
    plus the length mask as a float attn_mask built outside the timed call:
    not the same function (the position term precomputed), a yardstick
    beside the kernel (the port never calls it). Events ms into
    ``row["library_ms"]``; events and device ms in the log."""
    import torch
    import torch.nn.functional as F

    from reazonspeech_tpu_torch.ops.relpos_attention import rel_shift

    t, dh = qu.shape[2], qu.shape[3]
    scale = dh ** -0.5
    bd = torch.einsum("bhtd,lhd->bhtl", qv.float(), pos.float())
    mask = rel_shift(bd) * scale
    keys = torch.arange(t, device=qu.device)[None, None, None, :]
    mask = mask.masked_fill(keys >= lengths[:, None, None, None], -1e30).to(qu.dtype)
    qu, k, v = (x.contiguous() for x in (qu, k, v))

    def call():
        return F.scaled_dot_product_attention(qu, k, v, attn_mask=mask, scale=scale)

    row["library_ms"] = cuda_ms(call, 20)
    row["library_note"] = "not the same function: position term precomputed"
    items = device_items(call, 20)
    names = ", ".join(sorted({n[:60] for n, _, _ in items}))
    log(f"{row['name']} ({label}): scaled_dot_product_attention on the same q+u, k, v with "
        f"the position term and length mask as a precomputed float mask (not the same "
        f"function): events ms {row['library_ms']:.4f}, device ms "
        f"{fmt_ms(sum(ms for _, ms, _ in items) if items else None)} ({names}); the kernel's "
        f"device ms {fmt_ms(row['device_ms'])}")


# head widths past the published models' (rows 1, 7, 8, 9 at dh = 8 .. 256;
# rows 10-11 at qd up to 128 and pd up to 32): checked, not in the JSON line
HEAD_DIMS = (8, 36, 44, 80, 96, 256)
SHARED_WIDTHS = ((64, 4), (12, 9), (48, 16), (128, 32))


def head_width_checks(rand, dev):
    """Every rel-pos entry at the head widths the JAX kernels take beyond
    dh in (16, 32, 64, 128) (B=2, T=300, ragged lengths; 16 heads of dh = 8
    as the fused route packs them, else 4), and both shared-attention
    entries at (qd, pd) past (32, 4) (G=8, T=400, dv=12, 4 heads),
    tolerances as at the paths' shapes. Logged only."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_blockwise, relpos_attention_blockwise_plain,
        relpos_attention_plain,
    )

    f32 = torch.float32
    b, t = 2, 300
    lengths = torch.tensor([t, 173], dtype=torch.int32, device=dev)
    for dh in HEAD_DIMS:
        h = 16 if dh == 8 else 4
        d = h * dh
        pos = rand(2 * t - 1, h, dh, scale=0.5)
        bu, bv = rand(h, dh, scale=0.1, dtype=f32), rand(h, dh, scale=0.1, dtype=f32)
        qkv = rand(b, t, 3 * d, scale=0.5)
        q, kk, v = (x.contiguous() for x in qkv.chunk(3, dim=-1))
        label = f"dh={dh}, H={h}, T={t}"
        _compare("relpos_attention_fused_packed", ops.relpos_attention_fused_packed,
                 ops.relpos_attention_fused_packed_plain, (qkv, pos, bu, bv, lengths, h), 0.03,
                 iters=5, label=label, flops=flops_relpos)
        _compare("relpos_attention_fused", ops.relpos_attention_fused,
                 ops.relpos_attention_fused_plain, (q, kk, v, pos, bu, bv, lengths, h), 0.03,
                 iters=5, label=label, flops=flops_relpos)
        args = tuple(rand(b, h, t, dh, scale=0.5) for _ in range(4)) + (pos, lengths)
        _compare("relpos_attention", relpos_attention, relpos_attention_plain, args,
                 SHARED_ATOL, iters=5, label=label, flops=flops_relpos_bhtd)
        _compare("relpos_attention_blockwise", relpos_attention_blockwise,
                 relpos_attention_blockwise_plain, args, SHARED_ATOL, iters=5, label=label,
                 flops=flops_relpos_bhtd, plain_kwargs=dict(block=64))
    g, t, heads = 8, 400, 4
    lengths = torch.tensor([t, 1] + [t - 37 * i for i in range(2, g)], dtype=torch.int32,
                           device=dev)
    for qd, pd in SHARED_WIDTHS:
        args = (rand(g, t, qd, scale=0.5), rand(g, t, qd, scale=0.5), rand(g, t, pd),
                rand(heads, 2 * t - 1, pd), rand(g, t, 12), lengths)
        label = f"qd={qd}, pd={pd}, G={g}, T={t}"
        _compare("shared_rel_attention", ops.shared_rel_attention,
                 ops.shared_rel_attention_plain, args, SHARED_ATOL, iters=5,
                 kwargs=dict(heads=heads), label=label, flops=flops_shared)
        _compare("shared_rel_attention_blockwise", ops.shared_rel_attention_blockwise,
                 ops.shared_rel_attention_blockwise_plain, args, SHARED_ATOL, iters=5,
                 kwargs=dict(heads=heads), label=label, flops=flops_shared,
                 plain_kwargs=dict(block=64))


def _compare(name, kernel, plain, args, atol, iters, *, flops, kwargs=None, label=None,
             plain_kwargs=None, library=None):
    """Kernel against plain twin on the same inputs, then both timed.
    ``atol``: the max abs error allowed, "bf16" for :func:`bf16_tol`, or a
    tuple of those, one per output; ``label``: the shape, where a kernel is
    checked at more than one; ``flops(args, out)``: the call's operations
    for its bound; ``plain_kwargs``: extra arguments of the twin only;
    ``library``: one PyTorch call computing the same function on the same
    inputs, timed beside them (never used by the port)."""
    import torch

    kwargs = kwargs or {}
    twin_kwargs = {**kwargs, **(plain_kwargs or {})}
    what = f"{name} ({label})" if label else name
    got, want = kernel(*args, **kwargs), plain(*args, **twin_kwargs)
    torch.cuda.synchronize()
    bound, bound_by = bound_ms(flops(args, got), args, got)
    if name in ("topm_logsoftmax", "joint_topm"):  # indices equal, values within atol
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
    lib = ""
    library_ms = None
    if library is not None:
        library_ms = cuda_ms(library, iters)
        lib = f"; library call events ms {library_ms:.4f}, device ms " \
              f"{fmt_ms(device_ms(library, iters))}"
    log(f"{what}: max_abs_err {', '.join(stated)}; events ms kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}; device ms kernel {fmt_ms(dev_ms)}, plain {fmt_ms(plain_dev_ms)}; "
        f"bound {bound:.4f} ms ({bound_by}){lib}")
    # library_ms is null where no single PyTorch call computes the function
    # on these inputs (a chain: a norm then a product, scores with a
    # relative-position band, a joint then a log-softmax then a top-m)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms}


# --- phases 4 and 5: the nemo and k2 paths ------------------------------------


@contextlib.contextmanager
def plain_twins(only=None):
    """Run the same path with every kernel wrapper's plain twin in its place
    (or only those of the kernels named in ``only``)."""
    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding import rnnt_beam
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
    # both beam decoders take their step ops from rnnt_beam
    targets += [(rnnt_beam, name) for name in ("topm_logsoftmax",) + STEP_KERNELS]
    targets += [(zf, name) for name in K2_KERNELS]
    targets = [(mod, name) for mod, name in targets if only is None or name in only]
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

    nemo_profile(model, batch)
    reference_check(model)
    return {k: (counts[k] if k in SERVING_KERNELS else earlier_counts[k])
            for k in SERVING_KERNELS + EARLIER_KERNELS}


# the encoder kernels of each nemo LayerNorm configuration
NEMO_ENCODER_KERNELS = {"pallas": ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed",
                                   "fused_conv_module_ln", "add_ln"),
                        "xla": ("relpos_attention_fused", "fused_conv_module")}


def nemo_profile(model, batch):
    """Where the nemo encoder of the 4 x 30 s batch (the 32 s bucket: T=401)
    spends its device time, at full depth on the model's weights, in the
    serving configuration (lnd_impl="pallas") and in lnd_impl="xla": for
    each, its kernels' launches in one encode (every one must have
    launched), the device busy ms, device ops and largest items
    (torch.profiler, 3 encodes) and the CUDA-event ms (median of 5)."""
    import statistics
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode

    buf = np.zeros((len(batch), 32 * SR), np.float32)
    for i, a in enumerate(batch):
        buf[i, :len(a.waveform)] = a.waveform
    busy = {}
    with torch.inference_mode():
        wav = torch.from_numpy(buf).to(model.device)
        lens = torch.tensor([len(a.waveform) for a in batch], dtype=torch.int32,
                            device=model.device)
        feats, fl = log_mel_spectrogram(wav, lens, model.fe_cfg)
        for lnd, kernels in NEMO_ENCODER_KERNELS.items():
            cfg = replace(model.enc_cfg, lnd_impl=lnd)

            def encode():
                return fastconformer_encode(model.params["encoder"], feats, fl, cfg)

            ops.reset_launch_counts()
            enc, _ = encode()
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            check(all(counts.get(k, 0) > 0 for k in kernels),
                  f"nemo encoder, lnd_impl={lnd}: a kernel was not launched: {counts}")
            items = device_items(encode, 3)
            check(items, f"nemo encoder, lnd_impl={lnd}: the profiler recorded no device kernel")
            enc_ms = statistics.median(cuda_ms(encode, 1, warmup=0) for _ in range(5))
            busy[lnd] = sum(ms for _, ms, _ in items)
            log(f"nemo encoder 4 x 30 s (T={enc.shape[1]}), lnd_impl={lnd}: device busy "
                f"{busy[lnd]:.3f} ms, {sum(c for _, _, c in items):.0f} device ops; CUDA events "
                f"{enc_ms:.3f} ms (median of 5); kernel launches {counts}")
            for key, ms, calls in sorted(items, key=lambda x: -x[1])[:12]:
                log(f"nemo encoder item, lnd_impl={lnd}: {ms:.3f} ms x{calls:.0f} {key[:100]}")
    log(f"nemo encoder device busy: lnd_impl=pallas {busy['pallas']:.3f} ms, lnd_impl=xla "
        f"{busy['xla']:.3f} ms ({'below' if busy['pallas'] < busy['xla'] else 'not below'})")


def nemo_beam40_phase(name):
    """load_model(beam_size=40): ALSD beam 40, m = 40 label expansions a
    hypothesis on the top-m kernel (past its former cap of 32), at the
    xlarge width and depth; a 5 s transcribe with the kernel and with its
    plain twin: tokens equal under the near-tie rule. Returns the kernel's
    launches."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.nemo.asr import audio_from_numpy, load_model, transcribe

    model = load_model(device="cuda", checkpoint="random", beam_size=40)
    cfg = model.decode_cfg
    check((cfg.beam_size, cfg.topk_impl) == (40, "pallas"), f"nemo beam 40: {cfg}")
    audio = audio_from_numpy(speech_like(5.0, seed=70), SR)
    transcribe(model, audio)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = transcribe(model, audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["topm_logsoftmax"] > 0, f"nemo beam 40: the top-m kernel was not launched: "
                                         f"{counts}")
    check_results([res], [5.0])
    log(f"nemo ALSD beam 40, transcribe 5 s: {wall:.3f} s wall on {name}; "
        f"{counts['topm_logsoftmax']} top-m launches (m=40); {len(res.subwords)} subwords")

    def rerun(twins):
        with plain_twins(("topm_logsoftmax",)) if twins else contextlib.nullcontext():
            out = transcribe(model, audio)
            torch.cuda.synchronize()
        return out

    same_decode("nemo ALSD beam 40, 5 s", res, rerun(True), rerun, "alsd")
    del model
    return counts["topm_logsoftmax"]


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


def head_width_encoder_check():
    """A 4-block FastConformer encoder of d_model = 176 and 4 heads (dh = 44,
    which no kernel took before: the generic [B, H, T, dh] route, its
    single-pass entry at T <= 1024) in the GPU serving configuration on
    random weights: a short ragged batch through the kernels and through the
    same path with the plain twins, relative L2 <= 5e-2 on valid frames (as
    the full-width encoders); the rel-pos kernel must have launched."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import (
        FastConformerConfig, attention_route, fastconformer_encode,
    )
    from reazonspeech_tpu_torch.nemo.asr import load_model

    cfg = FastConformerConfig.xlarge(num_layers=4, d_model=176, num_heads=4, attn_impl="pallas",
                                     conv_impl="pallas", lnd_impl="pallas",
                                     compute_dtype="bfloat16", residual_dtype="float32")
    model = load_model(device="cuda", checkpoint="random", enc_cfg=cfg)
    wav = np.stack([speech_like(10.0, seed=70), speech_like(10.0, seed=71)])
    wav[1, 6 * SR:] = 0.0
    with torch.inference_mode():
        w = torch.from_numpy(wav).to(model.device)
        lens = torch.tensor([10 * SR, 6 * SR], dtype=torch.int32, device=model.device)
        feats, fl = log_mel_spectrogram(w, lens, model.fe_cfg)
        ops.reset_launch_counts()
        enc, el = fastconformer_encode(model.params["encoder"], feats, fl, model.enc_cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        with plain_twins():
            ref, _ = fastconformer_encode(model.params["encoder"], feats, fl, model.enc_cfg)
    route = attention_route(model.enc_cfg, enc.shape[1])
    log(f"dh=44 encoder (4 blocks, d=176, 4 heads, T={enc.shape[1]}): route {route}, "
        f"launches {({k: n for k, n in counts.items() if n})}")
    check(route == "generic" and counts["relpos_attention"] == 4,
          f"dh=44 encoder: route {route}, rel-pos launches {counts['relpos_attention']}")
    check(bool(torch.isfinite(enc).all()), "dh=44 encoder: non-finite output")
    valid = (torch.arange(enc.shape[1], device=enc.device)[None, :] < el[:, None])[..., None]
    rel = ((enc - ref) * valid).norm().item() / (ref * valid).norm().item()
    log(f"dh=44 encoder, kernels vs plain twins: relative L2 {rel:.3g} (tol 5e-2)")
    check(rel <= 5e-2, f"dh=44 encoder relative error {rel}")


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
    # decode_batch alone: the second-to-last Graves call (decode_single is the last)
    unswitched = (int(pops.ptot[-2]) / int(pops.frames[-2]),
                  (t2 - t1) * 1e3 / pops.host[-2]["pops_issued"])
    espnet_step_phase(model, buf, lens, name, unswitched)
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


# --- the beam decoders' step kernels (rows 12-13) ---------------------------


def _same(a, b):
    """Equal decode results: nests of arrays, tensors and result dataclasses."""
    import dataclasses

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


@contextlib.contextmanager
def recorded(kind, trace):
    """Append the search's state to ``trace`` after every ALSD step
    (``kind="alsd"``: each beam slot's score, tokens, count and frame, and
    the best final's key, tokens and count) or every Graves frame
    (``"graves"``: each kept hypothesis's score, token count and last
    token)."""
    from reazonspeech_tpu_torch.decoding import rnnt_beam as rb
    from reazonspeech_tpu_torch.decoding import transducer_graves as tg

    if kind == "alsd":
        make = rb._make_body

        def recording(*args, **kwargs):
            body = make(*args, **kwargs)

            def step(s):
                s = body(s)
                trace.append(tuple(x.clone() for x in (
                    s.scores, s.tokens, s.counts, s.time_idx, s.fin_key, s.fin_tokens,
                    s.fin_count)))
                return s

            return step

        rb._make_body = recording
        restore = lambda: setattr(rb, "_make_body", make)  # noqa: E731
    else:
        run = tg._Frame.run

        def recording(frame, waits):
            issued = run(frame, waits)
            at = (frame.bi[:, None], frame.knode)
            trace.append((frame.ks.clone(), frame.a["cnt"][at].clone(),
                          frame.a["last"][at].clone()))
            return issued

        tg._Frame.run = recording
        restore = lambda: setattr(tg._Frame, "run", run)  # noqa: E731
    try:
        yield trace
    finally:
        restore()


def first_divergence(kind, rec_k, rec_t):
    """(step, lane, slot, fp32 score gap) at the first ALSD step or Graves
    frame where the two recorded searches hold different hypotheses: the gap
    between the scores of the two candidates that hold that slot (slot -1:
    the best final); None where every recorded step agrees."""
    for i, (a, b) in enumerate(zip(rec_k, rec_t)):
        live = (a[0] > -1e25) | (b[0] > -1e25)
        if kind == "alsd":
            differ = ((a[1] != b[1]).any(-1) | (a[2] != b[2]) | (a[3] != b[3])) & live
        else:
            differ = ((a[1] != b[1]) | (a[2] != b[2])) & live
        if differ.any():
            lane, slot = (int(x) for x in differ.nonzero()[0])
            return i, lane, slot, abs(float(a[0][lane, slot]) - float(b[0][lane, slot]))
        if kind == "alsd":
            fin = (a[5] != b[5]).any(-1) | (a[6] != b[6])
            if fin.any():
                lane = int(fin.nonzero()[0, 0])
                return i, lane, -1, abs(float(a[4][lane]) - float(b[4][lane]))
    return None


def same_decode(what, got, want, rerun, kind):
    """The kernel run's tokens (``got``) must equal the twin run's
    (``want``). Where they differ, ``rerun(twins)`` repeats both runs
    recording the search; the first differing step and the fp32 score gap
    of the two candidates there are printed, and the check passes only when
    that gap is under 1e-4: a near-tie that the kernel's and the twin's fp32
    summation orders break differently."""
    if _same(got, want):
        log(f"{what}: tokens with the kernels == with their plain twins")
        return
    rec_k, rec_t = [], []
    with recorded(kind, rec_k):
        rerun(False)
    with recorded(kind, rec_t):
        rerun(True)
    div = first_divergence(kind, rec_k, rec_t)
    check(div is not None, f"{what}: the tokens differ but no recorded step does")
    step, lane, slot, gap = div
    log(f"{what}: tokens differ from the twins'; first differing "
        f"{'step' if kind == 'alsd' else 'frame'} {step}, lane {lane}, slot {slot}: fp32 score "
        f"gap {gap:.3g} between the two candidates (tol 1e-4)")
    check(gap < 1e-4, f"{what}: the tokens differ beyond an fp32 near-tie (gap {gap})")


def alsd_step_launches(params, rnnt_cfg, cfg, enc, el, steps=8):
    """(device launches, host ms) per ALSD alignment step: torch.profiler
    over ``steps`` steps of the body from the initial state (after as many
    unprofiled), and the host clock over as many more ending in a sync."""
    import torch

    from reazonspeech_tpu_torch.decoding import rnnt_beam as rb
    from reazonspeech_tpu_torch.models.rnnt import joint_precompute_enc

    pp, jp = params["predictor"], params["joint"]
    el = el.to(torch.int32)
    u_max = torch.floor(cfg.alsd_max_target_len * el.float()).to(torch.int32)
    body = rb._make_body(pp, jp, joint_precompute_enc(jp, enc, rnnt_cfg), el, u_max, rnnt_cfg,
                         cfg)
    state = [rb._init_state(pp, enc.shape[0], rnnt_cfg, cfg,
                            cfg.max_tokens or rb.alsd_step_bound(enc.shape[1], cfg), enc.device)]

    def run():
        for _ in range(steps):
            state[0] = body(state[0])

    items = device_items(run, 1)
    check(items, "ALSD: the profiler recorded no device kernel in the steps")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return sum(c for _, _, c in items) / steps, (time.perf_counter() - t0) * 1e3 / steps


def graves_pop_launches(params, rnnt_cfg, cfg, enc, el, frames=4):
    """Device launches per issued pop: torch.profiler over a Graves decode
    of the first ``frames`` encoder frames, over the pops it issued (the
    encoder projection and the per-frame compaction included)."""
    from reazonspeech_tpu_torch.decoding.transducer_graves import graves_beam_decode_stats

    head = (enc[:, :frames].contiguous(), el.clamp(max=frames))
    issued = []

    def run():
        issued.append(graves_beam_decode_stats(params["predictor"], params["joint"], *head,
                                               rnnt_cfg, cfg)[-1]["pops_issued"])

    items = device_items(run, 1)
    check(items, "Graves: the profiler recorded no device kernel in the pops")
    return sum(c for _, _, c in items) / issued[-1]


def nemo_step_path(name):
    """nemo ALSD beam 4 with both step kernels (joint_impl and
    lstm_impl="pallas"; pred_hidden 640 passes the LSTM kernel's guard) at
    the xlarge width and depth: transcribe_batch of 4 x 30 s with the
    kernels and with their plain twins (tokens equal under the near-tie
    rule), and the device launches and host ms per ALSD step with and
    without the switches on that batch's encoder output."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.rnnt_beam import BeamDecodeConfig
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode
    from reazonspeech_tpu_torch.nemo.asr import audio_from_numpy, load_model, transcribe_batch

    cfg = BeamDecodeConfig(beam_size=4, topk_impl="pallas", joint_impl="pallas",
                           lstm_impl="pallas")
    model = load_model(device="cuda", checkpoint="random", decode_cfg=cfg)
    enc_cfg, rnnt_cfg = model.enc_cfg, model.rnnt_cfg
    check((enc_cfg.d_model, enc_cfg.num_layers, enc_cfg.lnd_impl) == (1024, 24, "pallas"),
          "nemo step kernels: not the xlarge serving configuration")
    check(rnnt_cfg.predictor_kind == "lstm" and rnnt_cfg.pred_hidden % 128 == 0,
          "nemo step kernels: the LSTM kernel's guard refuses the predictor")
    batch = [audio_from_numpy(speech_like(30.0, seed=i), SR) for i in range(4)]
    transcribe_batch(model, batch[:1])  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = transcribe_batch(model, batch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"nemo ALSD with joint_impl/lstm_impl=pallas: launch counts {counts}")
    check(all(counts[k] > 0 for k in STEP_KERNELS), f"a step kernel was not launched: {counts}")
    check(counts["topm_logsoftmax"] == 0, "nemo: the top-m kernel ran beside joint_topm")
    check_results(res, [30.0] * 4)
    log(f"nemo transcribe_batch 4 x 30 s with the step kernels: {wall:.3f} s wall, "
        f"{120.0 / wall:.2f} audio-s/s on {name}; subwords {[len(r.subwords) for r in res]}")

    def rerun(twins):
        with plain_twins(STEP_KERNELS) if twins else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = transcribe_batch(model, batch)
            torch.cuda.synchronize()
        log(f"nemo transcribe_batch 4 x 30 s, step kernels {'twins' if twins else 'kernels'}: "
            f"{time.perf_counter() - t0:.3f} s wall")
        return out

    same_decode("nemo ALSD beam 4, 4 x 30 s", res, rerun(True), rerun, "alsd")

    buf = np.zeros((4, 32 * SR), np.float32)
    for i, a in enumerate(batch):
        buf[i, :len(a.waveform)] = a.waveform
    with torch.inference_mode():
        wav = torch.from_numpy(buf).to(model.device)
        lens = torch.full((4,), 30 * SR, dtype=torch.int32, device=model.device)
        feats, fl = log_mel_spectrogram(wav, lens, model.fe_cfg)
        enc, el = fastconformer_encode(model.params["encoder"], feats, fl, enc_cfg)
        for label, c in (("topk_impl=pallas only (the serving default)",
                          replace(cfg, joint_impl="xla", lstm_impl="xla")),
                         ("joint_impl/lstm_impl=pallas", cfg)):
            n, host_ms = alsd_step_launches(model.params, rnnt_cfg, c, enc, el)
            log(f"nemo ALSD step, R=16, {label}: {n:.1f} device launches a step, "
                f"{host_ms:.3f} host ms a step")
    del model
    return {k: counts[k] for k in STEP_KERNELS}


def espnet_step_phase(model, buf, lens, name, unswitched):
    """espnet Graves beam 20 with both step kernels (pred_hidden 256 passes
    the LSTM kernel's guard) on the four 20 s windows (B=4, T=549, the
    +12 blank bias kept): decode_batch with the kernels and with their
    plain twins (tokens equal under the near-tie rule), pops per lane-frame
    and ms per issued pop beside ``unswitched`` (the same figures of the
    serving configuration's decode_batch), and device launches per issued
    pop with and without the switches."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.espnet.asr import model as espnet_model

    cfg = replace(model.decode_cfg, joint_impl="pallas", lstm_impl="pallas")
    switched = replace(model, decode_cfg=cfg)
    ops.reset_launch_counts()
    with PopCounter(espnet_model) as pops:
        t0 = time.perf_counter()
        got = switched.decode_batch(buf, lens)
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"espnet Graves with joint_impl/lstm_impl=pallas: launch counts {counts}")
    check(all(counts[k] > 0 for k in STEP_KERNELS), f"a step kernel was not launched: {counts}")
    check(counts["topm_logsoftmax"] == 0, "espnet: the top-m kernel ran beside joint_topm")
    stats = pops.summary()
    issued = stats["issued_per_frame"] * stats["frames"]
    log(f"espnet decode_batch 4 x 20 s windows with the step kernels: {wall:.3f} s wall, "
        f"{80.0 / wall:.2f} audio-s/s on {name}; {stats['pops_per_lane_frame']:.2f} pops per "
        f"lane-frame, {wall * 1e3 / issued:.3f} ms per issued pop; serving configuration "
        f"(topk_impl=pallas only): {unswitched[0]:.2f} pops per lane-frame, "
        f"{unswitched[1]:.3f} ms per issued pop; tokens {got[2].tolist()}")

    def rerun(twins):
        with plain_twins(STEP_KERNELS) if twins else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = switched.decode_batch(buf, lens)
        log(f"espnet decode_batch, step kernels {'twins' if twins else 'kernels'}: "
            f"{time.perf_counter() - t0:.3f} s wall")
        return out

    same_decode("espnet Graves beam 20, 4 x 20 s windows", got, rerun(True), rerun, "graves")
    with torch.inference_mode():
        enc, el = _espnet_encode(model, buf, lens)
        for label, c in (("topk_impl=pallas only (the serving default)", model.decode_cfg),
                         ("joint_impl/lstm_impl=pallas", cfg)):
            n = graves_pop_launches(model.params, model.rnnt_cfg, c, enc, el)
            log(f"espnet Graves pop, B=4, {label}: {n:.1f} device launches per issued pop "
                f"(a 4-frame decode, compaction included)")
    return {k: counts[k] for k in STEP_KERNELS}


def k2_beam_path(name):
    """k2 load_model_container(decoding="beam") at ZipformerConfig.large():
    ALSD beam 4 over the stateless predictor with joint_impl="pallas"
    (lstm_impl has no LSTM to act on), transcribe_batch of 4 x 30 s with the
    joint kernel and with its plain twin (tokens equal under the near-tie
    rule)."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.rnnt_beam import BeamDecodeConfig
    from reazonspeech_tpu_torch.k2 import asr

    model = asr.model.load_model_container(device="cuda", checkpoint="random", decoding="beam")
    large = asr.model.ZipformerConfig.large()
    check((model.enc_cfg.num_layers, model.enc_cfg.encoder_dim) ==
          (large.num_layers, large.encoder_dim), "k2 beam: not the large width and depth")
    check(model.decode_cfg == BeamDecodeConfig(beam_size=4), "k2 beam: not ALSD beam 4")
    model = replace(model, decode_cfg=replace(model.decode_cfg, joint_impl="pallas"))
    batch = [asr.audio_from_numpy(speech_like(30.0, seed=30 + i), SR) for i in range(4)]
    asr.transcribe_batch(model, batch[:1])  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = asr.transcribe_batch(model, batch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"k2 ALSD beam 4 with joint_impl=pallas: launch counts {counts}")
    check(counts["joint_topm"] > 0, f"k2 beam: joint_topm was not launched: {counts}")
    check(counts["topm_logsoftmax"] == 0 and counts["lstm_cell_step"] == 0,
          "k2 beam: a kernel other than joint_topm ran in the decode")
    check_k2_results(res, [30.0] * 4)
    log(f"k2 transcribe_batch 4 x 30 s, ALSD beam 4 with joint_topm: {wall:.3f} s wall, "
        f"{120.0 / wall:.2f} audio-s/s on {name}; subwords {[len(r.subwords) for r in res]}")

    def rerun(twins):
        with plain_twins(STEP_KERNELS) if twins else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = asr.transcribe_batch(model, batch)
            torch.cuda.synchronize()
        log(f"k2 transcribe_batch 4 x 30 s, ALSD beam 4, joint "
            f"{'twin' if twins else 'kernel'}: {time.perf_counter() - t0:.3f} s wall")
        return out

    same_decode("k2 ALSD beam 4, 4 x 30 s", res, rerun(True), rerun, "alsd")
    return counts["joint_topm"]


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
    nemo_beam40_phase(f"{smi}")
    head_width_encoder_check()
    counts.update(nemo_step_path(f"{smi}"))  # rows 12-13 take their launches from here
    counts.update(k2_path(f"{smi}"))
    k2_beam_path(f"{smi}")
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
