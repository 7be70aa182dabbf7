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
   of 25 s (windows at T=549 and a short one, the find_blank passes on
   the packed route at T=499), decode_batch of four 10 s windows padded as
   transcribe pads them in a 20 s window's bucket (B=4, T=549),
   decode_single of 10 s and the encoder of a 45 s input (T=1124: the
   streamed entry; the windows and the single input cut from 20 s and 45 s
   to keep the smoke in its time limit); the mean pops per frame and the saturated count; the
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
   four windows cut to 5 s (the same bucket) with both switches, pops per lane-frame, ms and
   device launches per issued pop with and without them (the joint is two
   device launches a call, the top-m one). Each runs again
   with the two kernels' plain twins: the tokens must be equal, or else the
   first differing step's two candidates must lie within 1e-4 in fp32 (a
   near-tie the two summation orders break differently);
8. serving: each flavor at its full published width and depth in its GPU
   serving configuration (random weights from its seed) behind the HTTP
   front (make_app on a ThreadingHTTPServer at 127.0.0.1, port 0) over the
   lane-recycling ContinuousBatcher: nemo ALSD beam 4 (8 lanes, 32 steps a
   segment, 20 s windows, 4 encodes a tick) under 8 concurrent POST
   /transcribe of 2-20 s and one of 45 s (windowed by submit_long), then the
   45 s one on /transcribe_stream, /healthz and /metrics; k2 greedy (8
   lanes) under 5 requests of 3-20 s; espnet Graves beam 20 (4 lanes) with
   the joint's blank raised, under 3 requests of 2-5 s. Checked: no answer
   but 200, the drain ends with no lane busy, every kernel of the flavor's
   encode tick and segments launched, the stream's lines equal the 45 s
   answer, and each answer equals a MicroBatcher's of the pool's encode
   shape on the same requests (the 45 s one as its windows stitched by
   _window_keep), or else the request alone through a fresh pool gives the
   same answer and its recorded search first differs from the
   MicroBatcher's at an fp32 near-tie under 1e-4. Logged with the card's
   name and power limit: requests, executor wall s and audio-s/s beside the
   MicroBatcher's, segments, host ms per segment, lane occupancy, p50/p95
   latency;
9. converted paths: each flavor from an offline HF-hub snapshot of its
   published layout at the full published width and depth, built by
   tests/fixture_checkpoints.py (a .nemo archive at the xlarge width, an
   espnet-zoo directory at espnet_encoder_config() with the RNN-T head and
   GlobalMVN statistics, a sherpa k2 repo at ZipformerConfig.large() with
   its ONNX decoder/joiner and icefall .pt; the weights random from the
   file's seed): a plain load_model() on the card converts it with the
   port's converter (convert/), caches the tree and serves it (nemo
   transcribe_batch 4 x 30 s twice; k2 transcribe_batch 4 x 30 s twice
   and transcribe 60 s; espnet the CTC blank scan of a 20 s window,
   decode_batch of four windows cut to 5 s in the 22 s bucket, decode_single
   10 s and the encoder of a 45 s input, T=1124). Checked: the serving
   configuration at the published width, the tree's keys, shapes and dtypes
   against init, leaves against the state dict's tensors by published name
   bit for bit, every kernel of the flavor launched, the encoder against its
   plain twins (relative L2 <= 5e-2; espnet's also at the 45 s input), and a
   second load_model() with the
   hub deleted reading the cached tree without running the converter. The
   seconds of each step and the peak host RSS are logged;
10. decode options, v1 and 1seg (after serving): espnet decoding="maes"
   (mAES beam 20 on the top-m kernel, full width, the blank +12) on the
   espnet phase's four 10 s windows and 45 s input, its tokens and best
   scores against the top-m twin's, launches a frame, wall beside Graves
   beam 20's, row 3 at mAES's shape (R = 80, m = 22), then mAES in the
   executor behind the HTTP front under three 2-5 s requests (answers
   against a same-shape MicroBatcher's, or an fp32 near-tie); the v1
   transcribe of 45 s and a 1seg alignment of 20 s on that container (its
   ctc_probs against the plain twins, relative L2 <= 5e-2); Graves beam 20
   at multipop 1, 4 and 8 on four 3 s windows, with the default impls and
   with joint_impl/lstm_impl="pallas" (tokens against multipop 1's, or a
   near-tie; rounds a frame, launches a round, wall), rows 3, 12 and 13 at
   R = 16 and 32; k2 greedy at frame_window 1, 4 and 8 on
   transcribe_batch of 4 x 30 s (tokens against window 1's, or a bf16
   near-tie of window 1's decision; loop iterations, wall). Each path's
   kernels must have launched;
11. avsr (after the converted paths; no kernel of the 13 lies on this path):
   AVHubertForConditionalGeneration.init() with no device (CUDA, TF32 off)
   at the published AV-HuBERT base width (AVHubertConfig(): 12 encoder
   layers of 768, 12 heads, FFN 3,072; 6 decoder layers of 768, 4 heads;
   vocab 8,000; random weights from seed 0): generate on 16 audio-visual
   utterances of 4 s (inputs staged on the card) with beam 5 and greedy at
   max_length 128, each warmed once, then timed (wall and audio-s/s, host ms
   and device launches per decode step, device busy ms of the ResNet3D, the
   rest of the encoder and the decode loop by torch.profiler, and the device
   ms of the beam's cache reorder and of the cross-attention K/V projections
   a step); on a 1 x 1 s input, the encoder against the port on the CPU on
   the same weights (relative L2 <= 1e-4) and greedy and beam-5 tokens at
   max_length 8 against the CPU's (equal, or the first differing step's two
   candidates within 1e-4 in fp32), again with EOS's embedding row made to
   rank (1.5 x the row of the token greedy emits most) so that the banking
   pool runs; the converted path: write_avhubert_hf_dir at the full width,
   from_pretrained(dir) on the card, the tree's layout against init's, and
   tokens equal to the same weights loaded as a native tree; then
   make_avsr_app (max_batch 16) under 12 concurrent x-npz requests of 2-6 s
   (audio-visual, audio-only, video-only) and one WAV request: every answer
   200 and equal to the request's dedicated generate, or an fp32 near-tie
   under 1e-4; wall, audio-s/s, ticks and batch shapes, p50/p95 latency;
12. training (after avsr; all on the card, nothing at full width on the
   CPU): nemo's recipe, FastConformerConfig.xlarge(remat=True) with
   attn_impl and lnd_impl "pallas" and conv_impl "xla" (the conv kernel has
   no backward), bf16 compute, fp32 residual, RNNTConfig(), random weights
   from seed 0, B = 4 x 15 s of speech_like audio (one row 11 s) and U = 48
   labels from a numpy seed. The six kernel-forward autograd wrappers at
   the training shapes (rows 4-7 at T=188, rows 1 and 8 with separate
   q/k/v, row 8 at T=549 and, past 1024, row 9 at T=1100): the forward
   within relative L2 2e-2 of the plain forward, every input's gradient
   within 5e-2 of the plain twin's autograd gradient. compute_loss
   (loss="full") with the kernels against plain_twins() on the same params
   and batch: loss within 1e-2, the flattened gradient within relative L2
   5e-2, all finite; rows 4-7 launched in the forward and again in remat's
   recompute. Trainer.fit of 4 steps on the batch (warmup 1 step): the loss
   falls; ms a step, training audio-s/s, torch.cuda.max_memory_allocated.
   One step each of loss="pruned" (s_range 5) and ctc_weight=0.3: finite.
   At 2 blocks of the same width: a checkpoint at step 2, restore_latest
   and 2 more steps against an uninterrupted run to 4 (losses within 1e-2,
   the update within relative L2 1e-2; bit equality logged);
13. streaming (after training): the cache-based streaming FastConformer
   (models/fastconformer_streaming.py) on load_model(device="cuda",
   checkpoint="random") at the full nemo width (24 blocks, d=1024, the
   serving configuration: each FFN-in is row 4), StreamingConfig() (16-frame
   chunks of 1.28 s, left context 64, sub-context 16): streaming_encode of
   the frontend features of 4 x 30 s (23 chunks, 368 encoder frames) timed
   through the port's RTFxMeter, row 4 launched exactly 2 x 24 x 23 times
   and nothing else; the stepped loop bit-equal to it; causality at B=1;
   the encode against the plain twins (relative L2 <= 5e-2, no launch); at
   fp32 and 2 blocks of the full width, 4 chunks against the port on the
   CPU (relative L2 <= 1e-4); host ms, CUDA-event ms, device busy ms,
   device launches and latency a step at B=1 and B=4; one step under
   utils.profiling.trace, whose Chrome trace must name row 4's kernels.
   Row 4 is also held to its twin at the streaming shapes (M = 16 and 64
   rows, D = 1,024, dff = 4,096) among the kernel checks of phase 3;
14. host-side modules: native/ built by g++ on the machine (edit_distance
   against the Python one on 200 pairs, wav_batch_load of 8 WAVs against
   the Python decode); resample of 4 x 30 s at 48 and 44.1 kHz on the card
   against scipy's resample_poly in float64 (max abs <= 5e-4; device ms,
   peak memory); the evaluation harness over the nemo model on a local
   jsonl of 8 WAVs (evaluate(batch_size=4): predictions equal to
   transcribe_batch's, the printed CER equal to sum(distance)/sum(length));
   the kernel library loaded from a REAZONSPEECH_TPU_COMPILE_CACHE directory
   by a subprocess without nvcc, and reazonspeech-serve --compile-cache;
15. parallel: meshes whose entries name the card (cuda:(i % cards); on one
   card every entry is cuda:0, so placement and correctness, not scaling),
   nemo at the full xlarge serving width: DataParallelDecoder over 2
   entries on 4 x 10 s (each shard's rows bit-equal to a single-device
   decode_batch of them; wall s and audio-s/s beside one device's),
   ContinuousBatcher(mesh=2 entries) on 4 x 3 s against a MicroBatcher (or
   an fp32 near-tie), pipeline_parallel_encode at S=2, M=4 on 4 x 30 s
   against fastconformer_encode (relative L2 <= 5e-2; row 4 launched
   2 x 24 x M times; the bubble share), sequence_parallel_encode over 2
   entries in fp32 against the unsplit plain encode (relative L2 <= 1e-4),
   at the training configuration one pipeline step's loss (within 1e-5) and
   gradients (relative L2 <= 2.21e-3) against the single-device step's and
   Trainer(pipeline=) and Trainer(mesh=2x2) steps' losses against the
   single-device Trainer's (1e-5, rtol 1e-4), and rows 4, 5 and 7 at the
   tensor-parallel shapes (N = 2,048; q|k|v and attention of 4 heads)
   against their twins; each sub-step's seconds and each card's peak memory;
16. the kernels' JSON line (each kernel's time, its plain twin's, the bound
   of its work on this card, the launches on its path (row 4's include the
   streaming encode's; the tensor-parallel rows' are the dp x tp step's),
   and the time of one PyTorch call computing the same function where there
   is one), then the last line {"ok": true, "device": {"platform": "gpu",
   "kind": ..., "count": ...}}.

Every phase logs its seconds ("phase NAME: S s"), and the run ends with
their table. Imports no JAX. Runs in ~12 minutes on an H100, the build
included.
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
# rows 4, 5 and 7 at the tensor-parallel shapes (parallel_phase): the same kernels
TP_ROWS = {"ln_dense_tp": "ln_dense", "ln_dense_add_tp": "ln_dense_add",
           "relpos_attention_fused_packed_tp": "relpos_attention_fused_packed"}
REPLACES.update({tp: REPLACES[k] for tp, k in TP_ROWS.items()})
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
    "relpos_attention": "reazonspeech_tpu_torch/csrc/relpos_attention_single.cu",
    "relpos_attention_blockwise": "reazonspeech_tpu_torch/csrc/relpos_attention.cu",
    "fused_conv_module_layer": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
    "fused_conv_module_ln_layer": "reazonspeech_tpu_torch/csrc/conformer_conv.cu",
    "joint_topm": "reazonspeech_tpu_torch/csrc/joint_topm.cu",
    "lstm_cell_step": "reazonspeech_tpu_torch/csrc/lstm_step.cu",
}
SOURCES.update({tp: SOURCES[k] for tp, k in TP_ROWS.items()})
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
# the kernels behind the six training wrappers (``ops.*_diff``); rows 4-7
# run on the training path's packed attention route
TRAIN_WRAPPERS = ("ln_dense", "ln_dense_add", "add_ln", "relpos_attention_fused_packed",
                  "relpos_attention_fused", "relpos_attention")
TRAIN_KERNELS = TRAIN_WRAPPERS[:4]
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


PHASE_SECONDS = {}  # each phase's seconds, in the order the phases ran


@contextlib.contextmanager
def phase(key):
    """Log the seconds of the block as the phase ``key`` (also on failure)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[key] = time.perf_counter() - t0
        log(f"phase {key}: {PHASE_SECONDS[key]:.1f} s")


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


def device_calls(fn, calls, name, tries=6):
    """(device kernels named ``*name*`` a call, device span of a call in
    ms): torch.profiler over ``calls`` calls of fn() after a warm-up; the
    span runs from a call's first kernel start to its last kernel end, the
    median over the calls. The tracer drops a kernel record now and then: a
    profile whose count of such kernels is not a multiple of ``calls`` is
    taken again, up to ``tries`` times, every other time with the CUDA
    activity alone (the lighter trace). Where no count is a multiple, the
    count a call is ceil(most seen / calls) (dropped records only lower a
    count) and the span None. (0, None) where the profiles recorded device
    kernels but none named ``name``; (None, None) where no profile recorded
    any device kernel: not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most, any_kernel = 0, False
    for i in range(tries):
        acts = [ProfilerActivity.CUDA] if i % 2 else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ks = sorted((e.time_range.start, e.time_range.end) for e in kernels if name in e.name)
        any_kernel, most = any_kernel or bool(kernels), max(most, len(ks))
        if ks and len(ks) % calls == 0:
            n = len(ks) // calls
            spans = sorted(max(e for _, e in ks[i:i + n]) - ks[i][0] for i in range(0, len(ks), n))
            return n, spans[len(spans) // 2] / 1e3
    if not any_kernel:
        return None, None
    return -(-most // calls), None


def fmt_n(n):
    return "not measured" if n is None else str(n)


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
    streaming_kernel_checks(rand, dev)
    return rows


def streaming_kernel_checks(rand, dev):
    """Row 4 (ln_dense, the FFN-in with swish) at the streaming path's
    shapes: M = B x chunk_frames = 16 (B=1) and 64 (B=4) rows of the
    16-frame chunk, D = 1024, dff = 4096 (fewer rows than one 128-row TMA
    tile: its rows past M read zeros and store nothing). Logged only: row
    4's JSON entry is its serving-shape check."""
    import torch

    from reazonspeech_tpu_torch import ops

    f32, d = torch.float32, 1024
    g, beta = 1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32)
    w, c = rand(d, 4 * d, scale=0.5 * d ** -0.5), rand(4 * d, scale=0.1, dtype=f32)
    for b in (1, 4):
        x = rand(b, 16, d, dtype=f32) + 0.5
        _compare("ln_dense", ops.ln_dense, ops.ln_dense_plain, (x, g, beta, w, c), "bf16",
                 iters=50, kwargs=dict(activation="swish"), label=f"streaming FFN-in, M={16 * b}",
                 flops=flops_ln_dense)


def topm_yardstick(row, label, logits, m, blank, strict=True):
    """Row 3 beside torch.amax over the same logits (one PyTorch reduction
    reading the same bytes: the floor of any one-launch read of the rows;
    not the same function, and the port never calls it), events and device
    ms into ``row["amax_ms"]`` and the log; and one device kernel a call
    (logged only where not ``strict``: the profiler drops a kernel now and
    then, and the earlier phases hold the count)."""
    import torch

    from reazonspeech_tpu_torch import ops

    def amax():
        return torch.amax(logits, dim=-1)

    row["amax_ms"] = cuda_ms(amax, 200)
    n, _ = device_calls(lambda: ops.topm_logsoftmax(logits, m, blank), 20, "topm_kernel")
    log(f"topm_logsoftmax ({label}): torch.amax over the same logits (a yardstick, not the same "
        f"function): events ms {row['amax_ms']:.4f}, device ms {fmt_ms(device_ms(amax, 200))}; "
        f"the kernel's device ms {fmt_ms(row['device_ms'])}; {fmt_n(n)} device kernel(s) a call")
    check(n is None or n == 1 or not strict,
          f"topm_logsoftmax ({label}): {n} device kernels a call, not one")


def joint_yardstick(row, label, args, act, strict=True):
    """Row 12 beside the bare fp32 cuBLAS products dec·Wp and z·Wo on the
    same operands (TF32 off; a yardstick the port never calls: the kernel
    also applies the activation, the log-softmax and the top-m), events and
    device ms into ``row["cublas_ms"]`` and the log; the kernel's device
    kernels a call (at most two; logged only where not ``strict``) and its
    span beside its summed device ms."""
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
        f"{fmt_ms(cublas_dev)}; the kernel: {fmt_n(n)} device kernels a call, device ms summed "
        f"{fmt_ms(row['device_ms'])}, span (first start to last end) {fmt_ms(span)}")
    check(n is None or 0 < n <= 2 or not strict,
          f"joint_topm ({label}): {n} device kernels a call, not at most two")


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
    q = heads_first(q)
    sdpa_yardstick(rows[-1], "T=401, separate q/k/v", q + bu.to(bf16)[:, None],
                   q + bv.to(bf16)[:, None], heads_first(kk), heads_first(v), pos, lengths)
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
    args = bhtd(1, 1149, [1149])
    rows.append(_compare("relpos_attention_blockwise", relpos_attention_blockwise,
                         relpos_attention_blockwise_plain, args, SHARED_ATOL,
                         iters=10, label="B=1, T=1149", flops=flops_relpos_bhtd,
                         plain_kwargs=dict(block=64)))
    sdpa_yardstick(rows[-1], "B=1, T=1149", *args)

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
        log(f"lstm_cell_step ({label}, R={r}, H={h}): {fmt_n(n)} device kernel(s) a call")
        check(n is None or n == 1, f"lstm_cell_step ({label}): {n} device kernels a call, not one")
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
    (or only those of the kernels named in ``only``); the training wrappers
    (``*_diff``) take the twin of their forward, differentiated by autograd
    at the forward's dtypes."""
    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding import rnnt_beam, transducer_maes
    from reazonspeech_tpu_torch.models import fastconformer as fc
    from reazonspeech_tpu_torch.models import zipformer as zf
    from reazonspeech_tpu_torch.ops.relpos_attention import (
        relpos_attention_blockwise_plain, relpos_attention_plain,
    )

    def diff_twin(qu, qv, k, v, pos, lengths):  # relpos_attention_diff's forward, by T
        single = qu.shape[2] <= fc._SINGLE_PASS_MAX_T
        plain = relpos_attention_plain if single else relpos_attention_blockwise_plain
        return plain(qu, qv, k, v, pos, lengths)

    plains = {"relpos_attention": relpos_attention_plain,
              "relpos_attention_blockwise": relpos_attention_blockwise_plain,
              "relpos_attention_diff": diff_twin}
    targets = [(fc, name) for name in (
        "ln_dense", "ln_dense_add", "add_ln", "relpos_attention_fused",
        "relpos_attention_fused_packed", "fused_conv_module", "relpos_attention",
        "relpos_attention_blockwise")]
    targets += [(fc, name + "_diff") for name in TRAIN_WRAPPERS]
    # the ALSD and Graves decoders take their step ops from rnnt_beam, mAES
    # its top-m from its own module
    targets += [(rnnt_beam, name) for name in ("topm_logsoftmax",) + STEP_KERNELS]
    targets += [(transducer_maes, "topm_logsoftmax")]
    targets += [(zf, name) for name in K2_KERNELS]
    targets = [(mod, name) for mod, name in targets
               if only is None or name.removesuffix("_diff") in only]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name in targets:
        twin = plains.get(name) or getattr(ops, name.removesuffix("_diff") + "_plain")
        setattr(mod, name, twin)
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

    with phase("nemo_profile"):
        nemo_profile(model, batch)
    with phase("reference_check"):
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
    busy time of one profiled transcribe_batch (CUDA activity only), over
    its own wall time and over ``wall_s``, the wall time of the unprofiled
    call."""
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

    # the CUDA activity alone (kernel_profile): the greedy loop issues tens of
    # thousands of kernels, whose CPU-side events took the profiler ~30 s
    timed_call()  # warm-up
    busy, _, _ = kernel_profile(timed_call)  # walls[-1]: the profiled call
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
    its GPU serving configuration, Graves beam 20: transcribe of 25 s,
    decode_batch of four 10 s windows in the 22 s bucket (B=4, T=549),
    decode_single of 10 s and the encoder of a 45 s input (T=1124)."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.transducer_graves import GravesBeamConfig
    from reazonspeech_tpu_torch.espnet import asr
    from reazonspeech_tpu_torch.espnet.asr import model as espnet_model
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

    long_form = asr.audio_from_numpy(speech_like(ESPNET_LONG_S, seed=50), SR)
    buf, lens, single = espnet_inputs()
    model.decode_single(speech_like(2.0, seed=49))  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    with PopCounter(espnet_model) as pops:
        t0 = time.perf_counter()
        res = asr.transcribe(model, long_form, asr.TranscribeConfig(verbose=False))
        t1 = time.perf_counter()
        batch = model.decode_batch(buf, lens)
        t2 = time.perf_counter()
        tokens, frames = model.decode_single(speech_like(ESPNET_SINGLE_S, seed=61))
        t3 = time.perf_counter()
    with torch.inference_mode():  # the 45 s input's encoder: T=1124, the streamed entry
        long_enc, _ = _espnet_encode(model, single[None], np.array([len(single)], np.int32))
    counts = ops.launch_counts()
    log(f"espnet path: launch counts {counts}")
    check(all(counts[k] > 0 for k in ESPNET_KERNELS),
          f"an espnet kernel was not launched: {counts}")
    check(long_enc.shape[1] > 1024, f"espnet 45 s encoder: T={long_enc.shape[1]}")
    check_espnet_result(res, ESPNET_LONG_S)
    # 11.5 s of valid samples in the 22 s bucket: 287 valid of T=549 frames
    check(batch[3].tolist() == [287] * 4, f"espnet decode_batch: encoder lengths {batch[3]}")
    check(frames == sorted(frames) and all(0 <= f < ESPNET_SINGLE_S * 25 for f in frames),
          "espnet decode_single: emission frames out of order or range")
    log(f"espnet transcribe {ESPNET_LONG_S:.0f} s: {t1 - t0:.3f} s wall, "
        f"{ESPNET_LONG_S / (t1 - t0):.2f} audio-s/s "
        f"on {name}; {len(res.text)} characters, {len(res.segments)} segments")
    log(f"espnet decode_batch 4 x {ESPNET_WINDOW_S:.0f} s windows (B=4, T=549): "
        f"{t2 - t1:.3f} s wall, {4 * ESPNET_WINDOW_S / (t2 - t1):.2f} audio-s/s; tokens "
        f"{batch[2].tolist()}")
    log(f"espnet decode_single {ESPNET_SINGLE_S:.0f} s: {t3 - t2:.3f} s wall, "
        f"{ESPNET_SINGLE_S / (t3 - t2):.2f} "
        f"audio-s/s; {len(tokens)} tokens")
    ESPNET_GRAVES.update(batch_s=t2 - t1, single_s=t3 - t2, batch_tokens=batch[2].tolist(),
                         single_tokens=len(tokens))
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
    with phase("espnet_step_phase"):
        espnet_step_phase(model, buf, lens, name, unswitched)
    out = {k: counts[k] for k in ESPNET_ROWS if k != "fused_conv_module_layer"}
    from reazonspeech_tpu_torch.espnet.asr.transcribe import PADDING

    window = np.pad(speech_like(20.0, seed=51), PADDING)  # 21.5 s: T=549 > 512
    out["fused_conv_module_layer"] = espnet_xla_config(window)
    return out


ESPNET_GRAVES = {}  # the espnet phase's Graves beam 20 figures, beside which mAES is logged
# the espnet transcribe's input: a 20 s window and a short one (cut from 45 s,
# three windows, to keep the smoke inside its time limit: Graves beam 20 runs
# ~1.4 ms a pop, ~25 pops a frame)
ESPNET_LONG_S = 25.0
# the valid seconds of each window of the Graves and mAES decode_batch, in a
# 20 s window's 22 s bucket (cut from 20 s), and the Graves decode_single's
# input (cut from 45 s; the encoder still runs the 45 s input, for row 9)
ESPNET_WINDOW_S, ESPNET_SINGLE_S = 10.0, 10.0
# the valid seconds of each window in the decodes cut further (the step
# kernels' decode_batch, the converted path's): the same 22 s bucket
# (B=4, T=549), 162 valid frames
ESPNET_CUT_S = 5.0


def espnet_inputs():
    """The espnet phase's inputs: four windows of ESPNET_WINDOW_S seconds
    padded as transcribe pads them, in the 22 s bucket of a 20 s window
    (B=4, T=549; 287 valid frames each), their lengths, and a 45 s input
    (T=1149)."""
    from reazonspeech_tpu_torch.espnet.asr.transcribe import PADDING

    window = int(ESPNET_WINDOW_S * SR) + sum(PADDING)
    buf = np.zeros((4, 22 * SR), np.float32)
    for i in range(4):
        buf[i, :window] = np.pad(speech_like(ESPNET_WINDOW_S, seed=51 + i), PADDING)
    return buf, np.full(4, window, np.int32), speech_like(45.0, seed=60)


def cut_windows(buf, lens):
    """The 20 s windows of ``buf`` cut to their first ESPNET_CUT_S seconds
    (padded as transcribe pads them) in the same bucket: (buf, lens)."""
    from reazonspeech_tpu_torch.espnet.asr.transcribe import PADDING

    keep = PADDING[0] + int(ESPNET_CUT_S * SR)
    out = np.zeros_like(buf)
    out[:, :keep] = buf[:, :keep]
    return out, np.minimum(lens, keep + PADDING[1]).astype(np.int32)


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


def espnet_xla_config(window):
    """The espnet lnd_impl="xla" configuration at full width and 4 blocks
    (the attention and conv kernels, caller-side LayerNorms) through
    ctc_probs of ``window``, one padded 20 s window (the 22 s bucket, T=549):
    the [B, H, T, dh] route and the layer-norm conv module's caller-LN
    variant. Returns the latter's launches."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.espnet import asr
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config

    model = asr.load_model(device="cuda", checkpoint="random", enc_cfg=espnet_encoder_config(
        num_layers=4, attn_impl="pallas", conv_impl="pallas", lnd_impl="xla",
        compute_dtype="bfloat16", residual_dtype="float32"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lpz = model.ctc_probs(window)
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
    the best final's key, tokens and count), every Graves frame
    (``"graves"``: each kept hypothesis's score, token count and last
    token) or every mAES frame (``"maes"``: each beam slot's score, token
    count and last token; the frames run one a call, which changes
    nothing of the search)."""
    from reazonspeech_tpu_torch.decoding import rnnt_beam as rb
    from reazonspeech_tpu_torch.decoding import transducer_graves as tg
    from reazonspeech_tpu_torch.decoding import transducer_maes as tm

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
    elif kind == "maes":
        run_frames = tm._run_frames

        def recording(pp, jp, enc_proj, lane_len, state, rnnt_cfg, cfg, n_frames):
            for _ in range(n_frames):
                state = run_frames(pp, jp, enc_proj, lane_len, state, rnnt_cfg, cfg, 1)
                last = state.st.gather(2, (state.sc.long() - 1).clamp(min=0)[..., None])[..., 0]
                trace.append((state.cs.clone(), state.sc.clone(), last))
            return state

        tm._run_frames = recording
        restore = lambda: setattr(tm, "_run_frames", run_frames)  # noqa: E731
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
    """(step, lane, slot, fp32 score gap) at the first ALSD step or Graves or
    mAES frame where the two recorded searches hold different hypotheses: the gap
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


def same_decode(what, got, want, rerun, kind, versus="with the kernels == with their plain twins",
                tol=1e-4):
    """The kernel run's tokens (``got``) must equal the twin run's
    (``want``). Where they differ, ``rerun(twins)`` repeats both runs
    recording the search; the first differing step and the fp32 score gap
    of the two candidates there are printed, and the check passes only when
    that gap is under ``tol`` (1e-4): a near-tie that the kernel's and the
    twin's fp32 summation orders break differently. ``versus`` names the
    two runs in the log (another option against its reference run: the
    same rule)."""
    if _same(got, want):
        log(f"{what}: tokens {versus}")
        return
    rec_k, rec_t = [], []
    with recorded(kind, rec_k):
        rerun(False)
    with recorded(kind, rec_t):
        rerun(True)
    div = first_divergence(kind, rec_k, rec_t)
    check(div is not None, f"{what}: the tokens differ but no recorded step does")
    step, lane, slot, gap = div
    log(f"{what}: tokens differ from the reference run's; first differing "
        f"{'step' if kind == 'alsd' else 'frame'} {step}, lane {lane}, slot {slot}: fp32 score "
        f"gap {gap:.3g} between the two candidates (tol {tol:g})")
    check(gap < tol, f"{what}: the tokens differ beyond a near-tie (gap {gap})")


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
    the LSTM kernel's guard) on the four windows cut to their first 5 s in
    the same 22 s bucket (B=4, T=549, 162 valid frames; the +12 blank bias
    kept): decode_batch with the kernels and with their plain twins (tokens
    equal under the near-tie rule), pops per lane-frame and ms per issued
    pop beside ``unswitched`` (the same figures of the serving
    configuration's decode_batch of the whole windows), and device launches
    per issued pop with and without the switches."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.espnet.asr import model as espnet_model

    cfg = replace(model.decode_cfg, joint_impl="pallas", lstm_impl="pallas")
    switched = replace(model, decode_cfg=cfg)
    buf, lens = cut_windows(buf, lens)
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
    log(f"espnet decode_batch 4 x {ESPNET_CUT_S:.0f} s windows with the step kernels: "
        f"{wall:.3f} s wall, {4 * ESPNET_CUT_S / wall:.2f} audio-s/s on {name}; {stats['pops_per_lane_frame']:.2f} pops per "
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

    same_decode(f"espnet Graves beam 20, 4 x {ESPNET_CUT_S:.0f} s windows", got, rerun(True),
                rerun, "graves")
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


# --- phase 8: the converted paths --------------------------------------------

# the fixture espnet joint's blank logit raised before the zoo is written, so
# that Graves ends frames by ESPnet's test as a trained model does: without
# it the fixture's random joint runs every frame to the pop cap (128 pops a
# lane-frame on the CPU at a tiny width), with it ~21, beam 20's floor
CONVERTED_BLANK_BIAS = 16.0


class PeakRss:
    """The peak host resident set of the process over a block, sampled
    every 10 ms from /proc/self/statm by a thread that the block's end
    stops, beside the resident set at its start."""

    def __init__(self):
        import os
        import threading

        self.page, self.stop = os.sysconf("SC_PAGE_SIZE"), threading.Event()
        self.start = self.peak = self._rss()
        self.thread = threading.Thread(target=self._sample, daemon=True)

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _sample(self):
        while not self.stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()

    def __str__(self):
        return f"{self.peak / 1e9:.2f} GB ({self.start / 1e9:.2f} GB at the start)"


@contextlib.contextmanager
def swapped(module, attr, make):
    """``module.attr`` is ``make(module.attr)`` within the block."""
    fn = getattr(module, attr)
    setattr(module, attr, make(fn))
    try:
        yield
    finally:
        setattr(module, attr, fn)


def timing(seconds, key):
    """A wrapper that adds the seconds of every call to ``seconds[key]``."""
    def make(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return wrapper
    return make


def refusing(fn):
    def raise_(*args, **kwargs):
        raise AssertionError(f"{fn.__name__} ran although the converted tree is cached")
    return raise_


@contextlib.contextmanager
def offline_caches(root):
    """The HF hub cache and the converted-tree cache under ``root``, offline."""
    import os

    env = {"HF_HUB_CACHE": os.path.join(root, "hub"), "HF_HOME": os.path.join(root, "hf"),
           "HF_HUB_OFFLINE": "1", "REAZONSPEECH_TPU_CACHE": os.path.join(root, "converted")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env["HF_HUB_CACHE"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_tree_layout(what, got, want):
    """The same keys, and at each the same shape and dtype."""
    def layout(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in layout(v, f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in layout(v, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}

    g, w = layout(got), layout(want)
    diff = sorted(k for k in set(g) | set(w) if g.get(k) != w.get(k))
    check(not diff, f"{what}: the converted tree differs from init at {diff[:6]}")
    log(f"{what}: the converted tree has init's {len(w)} leaves, shapes and dtypes")


def same_leaves(what, pairs):
    """Each converted leaf equals its published tensor under the transform
    written beside it, bit for bit."""
    import torch

    for label, leaf, want in pairs:
        got = leaf.detach().cpu()
        want = torch.as_tensor(want)
        check(got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want),
              f"{what}: {label} differs from the published tensor")
    log(f"{what}: {len(pairs)} leaves equal their published tensors bit for bit: "
        + "; ".join(label for label, _, _ in pairs))


def converted_encoder_check(what, model, encode, wav=None, lens=None):
    """A 5 s and a 3 s input (or ``wav`` with ``lens``) through the encoder
    with the kernels and with their plain twins, on the converted weights
    (relative L2 <= 5e-2 on the valid frames, as reference_check)."""
    import torch

    if wav is None:
        wav = np.stack([speech_like(5.0, seed=70), speech_like(5.0, seed=71)])
        wav[1, 3 * SR:] = 0.0
        lens = np.array([5 * SR, 3 * SR], np.int32)
    with torch.inference_mode():
        enc, el = encode(wav, lens)
        with plain_twins():
            ref, _ = encode(wav, lens)
    check(bool(torch.isfinite(enc).all()), f"{what}: non-finite encoder output")
    valid = (torch.arange(enc.shape[1], device=enc.device)[None, :] < el[:, None])[..., None]
    rel = ((enc.float() - ref.float()) * valid).norm().item() / (ref.float() * valid).norm().item()
    log(f"{what} encoder on the converted weights (B={wav.shape[0]}, T={enc.shape[1]}), kernels "
        f"vs plain twins: relative L2 {rel:.3g} (tol 5e-2)")
    check(rel <= 5e-2, f"{what} encoder relative error {rel}")


def _host_encode(model, encode_feats):
    """(wav, lens) host arrays -> frontend -> ``encode_feats`` on the card."""
    import torch

    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram

    def encode(wav, lens):
        w = torch.from_numpy(np.ascontiguousarray(wav)).to(model.device)
        lengths = torch.from_numpy(lens).to(model.device)
        feats, fl = log_mel_spectrogram(w, lengths, model.fe_cfg)
        return encode_feats(model.params["encoder"], feats, fl, model.enc_cfg)

    return encode


def load_converted(what, load, loader_module, converter, converter_module, npz):
    """The first load_model() of a snapshot (it converts), then the second
    with the hub deleted (it must read the cached tree and convert nothing).
    Returns (model, seconds)."""
    import os
    import shutil

    import torch

    seconds = {}
    t0 = time.perf_counter()
    with swapped(loader_module, converter, timing(seconds, "conversion")), \
            swapped(converter_module, "save_param_tree", timing(seconds, "tree save")):
        model = load()
    torch.cuda.synchronize()
    seconds["first load_model"] = time.perf_counter() - t0
    seconds["conversion"] -= seconds["tree save"]
    check(os.path.exists(npz), f"{what}: no converted tree at {npz}")
    mtime = os.path.getmtime(npz)
    shutil.rmtree(os.environ["HF_HUB_CACHE"])
    t0 = time.perf_counter()
    with swapped(loader_module, converter, refusing):
        again = load()
    torch.cuda.synchronize()
    seconds["load from the cache"] = time.perf_counter() - t0
    check(os.path.getmtime(npz) == mtime, f"{what}: the cached tree was written again")
    a, b = (m.params["joint"]["out"]["w"] for m in (model, again))
    check(torch.equal(a, b), f"{what}: the second load's weights differ from the first's")
    log(f"{what}: the second load_model() with the hub deleted read the cached tree "
        f"({os.path.getsize(npz) / 1e9:.2f} GB) and ran no converter")
    del again
    return model, seconds


def converted_nemo(root):
    import torch

    import fixture_checkpoints as fx

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.convert import nemo_fastconformer
    from reazonspeech_tpu_torch.core.hub import converted_path
    from reazonspeech_tpu_torch.models.fastconformer import (
        FastConformerConfig, fastconformer_encode,
    )
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
    from reazonspeech_tpu_torch.nemo import asr
    from reazonspeech_tpu_torch.nemo.asr import model as nemo_model

    enc_cfg = FastConformerConfig.xlarge()
    rnnt_cfg = RNNTConfig(enc_dim=enc_cfg.d_model)
    t0 = time.perf_counter()
    with offline_caches(root) as hub:
        sd = fx.synth_nemo_state_dict(enc_cfg, rnnt_cfg)
        fx.write_hf_snapshot(hub, nemo_model.HF_REPO_ID, lambda snap: fx.write_nemo_archive(
            f"{snap}/reazonspeech-nemo-v2.nemo", enc_cfg, rnnt_cfg, sd=sd))
        seconds = {"snapshot write": time.perf_counter() - t0}
        model, more = load_converted("nemo", asr.load_model, nemo_model,
                                     "convert_nemo_checkpoint", nemo_fastconformer,
                                     converted_path(nemo_model.HF_REPO_ID, "model") + ".npz")
    seconds.update(more)
    check(model.enc_cfg == nemo_model._cuda_serving_config(FastConformerConfig.xlarge()),
          f"nemo: not the xlarge serving configuration: {model.enc_cfg}")
    check(model.rnnt_cfg == rnnt_cfg, f"nemo: not the published decoder: {model.rnnt_cfg}")
    check((model.decode_cfg.beam_size, model.decode_cfg.topk_impl) == (4, "pallas"),
          f"nemo: not the archive's ALSD beam 4 on the top-m kernel: {model.decode_cfg}")
    same_tree_layout("nemo", model.params,
                     nemo_model.init_params(0, model.enc_cfg, model.rnnt_cfg, model.device))
    p, h = model.params, rnnt_cfg.pred_hidden
    enc, last = p["encoder"]["blocks"], enc_cfg.num_layers - 1
    w_ih = sd["decoder.prediction.dec_rnn.lstm.weight_ih_l0"]
    same_leaves("nemo", [
        ("joint.enc.w = joint.enc.weightᵀ", p["joint"]["enc"]["w"], sd["joint.enc.weight"].T),
        ("blocks.attn_q.w[0] = layers.0.self_attn.linear_q.weightᵀ", enc["attn_q"]["w"][0],
         sd["encoder.layers.0.self_attn.linear_q.weight"].T),
        (f"blocks.attn_q.w[{last}] = layers.{last}.self_attn.linear_q.weightᵀ",
         enc["attn_q"]["w"][last], sd[f"encoder.layers.{last}.self_attn.linear_q.weight"].T),
        ("lstm[0].w_ih[:, H:2H] = weight_ih_l0[H:2H]ᵀ (gate f)",
         p["predictor"]["lstm"][0]["w_ih"][:, h:2 * h], w_ih[h:2 * h].T),
        ("lstm[0].w_ih = weight_ih_l0ᵀ (gates i, f, g, o)", p["predictor"]["lstm"][0]["w_ih"],
         w_ih.T),
        ("blocks.conv_dw.w[5] = layers.5.conv.depthwise_conv.weight [C, 1, K] -> [K, 1, C]",
         enc["conv_dw"]["w"][5],
         sd["encoder.layers.5.conv.depthwise_conv.weight"].permute(2, 1, 0)),
    ])

    batch = [asr.audio_from_numpy(speech_like(30.0, seed=80 + i), SR) for i in range(4)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = asr.transcribe_batch(model, batch)
    t1 = time.perf_counter()
    res = asr.transcribe_batch(model, batch)
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    seconds.update({"first transcribe_batch": t1 - t0, "second transcribe_batch": t2 - t1})
    log(f"nemo converted path: launch counts {counts}")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"nemo converted path: a kernel was not launched: {counts}")
    check_results(res, [30.0] * 4)
    check([r.text for r in first] == [r.text for r in res], "nemo: two runs gave other texts")
    converted_encoder_check("nemo", model, _host_encode(model, fastconformer_encode))
    return seconds


def converted_espnet(root):
    import fixture_checkpoints as fx
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.convert import espnet_conformer
    from reazonspeech_tpu_torch.core.hub import converted_path
    from reazonspeech_tpu_torch.decoding.transducer_graves import GravesBeamConfig
    from reazonspeech_tpu_torch.espnet import asr
    from reazonspeech_tpu_torch.espnet.asr import model as espnet_model
    from reazonspeech_tpu_torch.espnet.asr.ctc import find_blank
    from reazonspeech_tpu_torch.espnet.asr.transcribe import PADDING
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig

    enc_cfg = espnet_encoder_config()
    tokens = espnet_model.default_token_list()
    rnnt_cfg = RNNTConfig(vocab_size=len(tokens), enc_dim=enc_cfg.d_model, pred_hidden=256,
                          joint_hidden=256, joint_activation="tanh", predictor_kind="lstm",
                          blank_position="first")
    t0 = time.perf_counter()
    with offline_caches(root) as hub:
        sd = fx.synth_espnet_state_dict(enc_cfg, len(tokens), rnnt_cfg)
        sd["joint_network.lin_out.bias"][0] += CONVERTED_BLANK_BIAS
        snap = fx.write_hf_snapshot(hub, espnet_model.HF_REPO_ID,
                                    lambda snap: fx.write_espnet_zoo(snap, enc_cfg, tokens,
                                                                     rnnt_cfg, sd=sd))
        run = f"{snap}/exp/asr_train_asr_conformer_raw_jp_char"
        with np.load(f"{run}/feats_stats.npz") as stats:
            stats = dict(stats)
        seconds = {"snapshot write": time.perf_counter() - t0}
        model, more = load_converted("espnet", asr.load_model, espnet_model,
                                     "convert_espnet_checkpoint", espnet_conformer,
                                     converted_path(espnet_model.HF_REPO_ID, "model") + ".npz")
    seconds.update(more)
    check(model.enc_cfg == espnet_model._cuda_serving_config(espnet_encoder_config()),
          f"espnet: not the full-width serving configuration: {model.enc_cfg}")
    check(model.rnnt_cfg == rnnt_cfg, f"espnet: not the zoo's decoder: {model.rnnt_cfg}")
    check(model.decode_cfg == GravesBeamConfig(beam_size=20, topk_impl="pallas"),
          "espnet: not Graves beam 20 on the top-m kernel")
    check(model.token_list == tokens, "espnet: the token list is not config.yaml's")
    p = dict(model.params)
    norm = p.pop("normalize")
    random = espnet_model.load_model_container(checkpoint="random", enc_cfg=model.enc_cfg,
                                               rnnt_cfg=model.rnnt_cfg, token_list=tokens,
                                               device=model.device)
    same_tree_layout("espnet", p, random.params)
    del random
    # GlobalMVN from the zoo's collect_stats npz: mean = sum/count,
    # std = sqrt(sum_square/count - mean²), in float64, then float32
    count = float(stats["count"].reshape(-1)[0])
    mean = stats["sum"].reshape(-1) / count
    std = np.sqrt(np.maximum(stats["sum_square"].reshape(-1) / count - mean * mean, 1.0e-20))
    enc, h = p["encoder"]["blocks"], rnnt_cfg.pred_hidden
    w_ih = sd["decoder.decoder.0.weight_ih_l0"]
    same_leaves("espnet", [
        ("joint.enc.w = joint_network.lin_enc.weightᵀ", p["joint"]["enc"]["w"],
         sd["joint_network.lin_enc.weight"].T),
        ("joint.out.b = joint_network.lin_out.bias", p["joint"]["out"]["b"],
         sd["joint_network.lin_out.bias"]),
        ("blocks.attn_q.w[0] = encoders.0.self_attn.linear_q.weightᵀ", enc["attn_q"]["w"][0],
         sd["encoder.encoders.0.self_attn.linear_q.weight"].T),
        ("blocks.attn_q.w[11] = encoders.11.self_attn.linear_q.weightᵀ", enc["attn_q"]["w"][11],
         sd["encoder.encoders.11.self_attn.linear_q.weight"].T),
        ("blocks.ffn1_in.w[3] = encoders.3.feed_forward_macaron.w_1.weightᵀ",
         enc["ffn1_in"]["w"][3], sd["encoder.encoders.3.feed_forward_macaron.w_1.weight"].T),
        ("lstm[0].w_ih[:, 2H:3H] = decoder.0.weight_ih_l0[2H:3H]ᵀ (gate g)",
         p["predictor"]["lstm"][0]["w_ih"][:, 2 * h:3 * h], w_ih[2 * h:3 * h].T),
        ("blocks.conv_dw.w[7] = encoders.7.conv_module.depthwise_conv.weight [C, 1, K] -> "
         "[K, 1, C]", enc["conv_dw"]["w"][7],
         sd["encoder.encoders.7.conv_module.depthwise_conv.weight"].permute(2, 1, 0)),
        ("normalize.mean = feats_stats sum/count", norm["mean"], mean.astype(np.float32)),
        ("normalize.std = feats_stats sqrt(sum_square/count - mean²)", norm["std"],
         std.astype(np.float32)),
    ])

    window = int(21.5 * SR)  # a 20 s window padded as transcribe pads it
    buf = np.zeros((4, 22 * SR), np.float32)
    for i in range(4):
        buf[i, :window] = np.pad(speech_like(20.0, seed=91 + i), PADDING)
    buf, lens = cut_windows(buf, np.full(4, window, np.int32))
    long_wav = speech_like(45.0, seed=95)
    # the CTC blank scan that transcribe runs on each 20 s window (T=499:
    # the packed route), then Graves beam 20 at T=549 on the windows cut to
    # 5 s and on a 10 s input (cut from 20 s windows and 45 s: Graves beam
    # 20 runs ~1.5 ms a pop, ~21 pops a lane-frame), and the encoder of a
    # 45 s input (T=1124: the streamed entry, held to its twins below)
    ops.reset_launch_counts()
    with PopCounter(espnet_model) as pops:
        t0 = time.perf_counter()
        blank = find_blank(model, speech_like(20.0, seed=90))
        t1 = time.perf_counter()
        batch = model.decode_batch(buf, lens)
        t2 = time.perf_counter()
        tokens_1, frames_1 = model.decode_single(speech_like(10.0, seed=95))
        t3 = time.perf_counter()
    with torch.inference_mode():
        long_enc, _ = _espnet_encode(model, long_wav[None], np.array([len(long_wav)], np.int32))
    counts = ops.launch_counts()
    seconds.update({"find_blank 20 s": t1 - t0, "decode_batch": t2 - t1,
                    "decode_single 10 s": t3 - t2})
    log(f"espnet converted path: launch counts {counts}")
    check(all(counts[k] > 0 for k in ESPNET_KERNELS),
          f"espnet converted path: a kernel was not launched: {counts}")
    check(long_enc.shape[1] > 1024, f"espnet 45 s encoder: T={long_enc.shape[1]}")
    check(0 <= blank[0] <= blank[1] <= 20 * SR, f"espnet find_blank: {blank}")
    check(batch[3].tolist() == [162] * 4, f"espnet decode_batch: encoder lengths {batch[3]}")
    check(frames_1 == sorted(frames_1) and all(0 <= f < 250 for f in frames_1),
          "espnet decode_single: emission frames out of order or range")
    stats = pops.summary()
    log(f"espnet converted path: decode_batch tokens {batch[2].tolist()}, decode_single "
        f"{len(tokens_1)} tokens, blank run {tuple(blank)}; Graves beam 20: "
        f"{stats['pops_per_lane_frame']:.2f} pops per lane-frame, saturated lanes "
        f"{stats['saturated_lanes']}")
    converted_encoder_check("espnet", model, lambda wav, lens: _espnet_encode(model, wav, lens))
    converted_encoder_check("espnet", model, lambda wav, lens: _espnet_encode(model, wav, lens),
                            wav=long_wav[None], lens=np.array([len(long_wav)], np.int32))
    return seconds


def converted_k2(root):
    import fixture_checkpoints as fx

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.convert import onnx_zipformer
    from reazonspeech_tpu_torch.core.hub import converted_path
    from reazonspeech_tpu_torch.k2 import asr
    from reazonspeech_tpu_torch.k2.asr import huggingface as k2hf
    from reazonspeech_tpu_torch.k2.asr import model as k2_model
    from reazonspeech_tpu_torch.models import zipformer as zf
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig

    enc_cfg = zf.ZipformerConfig.large()
    tokens = k2_model.default_k2_token_list()
    rnnt_cfg = RNNTConfig(vocab_size=len(tokens), enc_dim=enc_cfg.out_dim, pred_hidden=512,
                          joint_hidden=512, joint_activation="tanh", predictor_kind="stateless",
                          context_size=2)
    repo_id, epochs = k2hf.LANGUAGE_MODELS["ja"]
    t0 = time.perf_counter()
    with offline_caches(root) as hub:
        sd = fx.synth_icefall_state_dict(enc_cfg, rnnt_cfg)
        fx.write_hf_snapshot(hub, repo_id, lambda snap: fx.write_k2_repo(
            snap, enc_cfg, rnnt_cfg, tokens, epochs, sd=sd))
        seconds = {"snapshot write": time.perf_counter() - t0}
        model, more = load_converted("k2", asr.load_model, k2hf, "convert_sherpa_snapshot",
                                     onnx_zipformer, converted_path(repo_id, "fp32") + ".npz")
    seconds.update(more)
    check(model.enc_cfg == k2_model._cuda_serving_config(zf.ZipformerConfig.large()),
          f"k2: not the large serving configuration: {model.enc_cfg}")
    check(model.rnnt_cfg == rnnt_cfg, f"k2: not the graphs' decoder: {model.rnnt_cfg}")
    check(model.token_list == tokens, "k2: the token list is not tokens.txt's")
    random = k2_model.load_model_container(checkpoint="random", enc_cfg=model.enc_cfg,
                                           rnnt_cfg=model.rnnt_cfg, token_list=tokens,
                                           device=model.device)
    same_tree_layout("k2", model.params, random.params)
    del random
    p = model.params
    stacks = p["encoder"]["stacks"]
    d = rnnt_cfg.pred_hidden
    same_leaves("k2", [
        ("joint.enc.w = joiner.encoder_proj.weightᵀ (ONNX)", p["joint"]["enc"]["w"],
         sd["joiner.encoder_proj.weight"].T),
        ("predictor.ctx_proj.w = decoder.conv.weight [D, D, 2] -> [2·D, D] (ONNX)",
         p["predictor"]["ctx_proj"]["w"],
         sd["decoder.conv.weight"].permute(2, 1, 0).reshape(2 * d, d)),
        ("stacks[3].layers.attn_pos.w[4] = encoders.3.encoder.layers.4.self_attn_weights."
         "linear_pos.weightᵀ", stacks[3]["layers"]["attn_pos"]["w"][4],
         sd["encoder.encoders.3.encoder.layers.4.self_attn_weights.linear_pos.weight"].T),
        ("stacks[0].layers.attn_qkp.w[1] = encoders.0.layers.1.self_attn_weights.in_proj."
         "weightᵀ", stacks[0]["layers"]["attn_qkp"]["w"][1],
         sd["encoder.encoders.0.layers.1.self_attn_weights.in_proj.weight"].T),
        ("stacks[2].layers.cv1_dw.w[0] = encoders.2.encoder.layers.0.conv_module1."
         "depthwise_conv.weight [C, 1, K] -> [K, 1, C]", stacks[2]["layers"]["cv1_dw"]["w"][0],
         sd["encoder.encoders.2.encoder.layers.0.conv_module1.depthwise_conv.weight"]
         .permute(2, 1, 0)),
    ])

    batch = [asr.audio_from_numpy(speech_like(30.0, seed=100 + i), SR) for i in range(4)]
    long_form = asr.audio_from_numpy(speech_like(60.0, seed=105), SR)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = asr.transcribe_batch(model, batch)
    t1 = time.perf_counter()
    res = asr.transcribe_batch(model, batch)
    t2 = time.perf_counter()
    res_long = asr.transcribe(model, long_form)
    t3 = time.perf_counter()
    counts = ops.launch_counts()
    seconds.update({"first transcribe_batch": t1 - t0, "second transcribe_batch": t2 - t1,
                    "transcribe 60 s": t3 - t2})
    log(f"k2 converted path: launch counts {counts}")
    check(all(counts[k] > 0 for k in K2_KERNELS),
          f"k2 converted path: a kernel was not launched: {counts}")
    check_k2_results(res, [30.0] * 4)
    check_k2_results([res_long], [60.0])
    check([r.text for r in first] == [r.text for r in res], "k2: two runs gave other texts")
    converted_encoder_check("k2", model, _host_encode(model, zf.zipformer_encode))
    return seconds


def converted_paths(name):
    """Each flavor from a snapshot of its published layout at the full
    published width and depth (tests/fixture_checkpoints.py's writers, the
    weights random from its seed): a plain load_model() on the card converts
    it with the port's converter, caches the tree and serves it; the checks
    of the phase (configuration, tree layout, leaves by published name,
    kernel launches, encoder against its plain twins, the second load from
    the cache) fail the run. Each flavor's files go to a directory under
    build/ that is removed afterwards."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    import yaml  # the .nemo and espnet-zoo configs are YAML, read with PyYAML

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    log(f"converted paths: every flavor through its snapshot (PyYAML {yaml.__version__})")
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    for flavor, run in (("nemo", converted_nemo), ("k2", converted_k2),
                        ("espnet", converted_espnet)):
        root = tempfile.mkdtemp(prefix=f"converted_{flavor}_", dir=base)
        t0 = time.perf_counter()
        try:
            with PeakRss() as rss:
                seconds = run(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
        log(f"{flavor} converted path on {name}: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
            + f"; peak host RSS {rss}; the flavor took "
            f"{time.perf_counter() - t0:.1f} s")


# --- the serving stack: the continuous executor behind the HTTP front --------

# the encoder kernels of the packed attention route, which the nemo and
# espnet encode ticks take at their 20 s windows (T=250 and 499)
PACKED_ROUTE_KERNELS = ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed", "add_ln")


class HttpFront:
    """make_app's handler on a ThreadingHTTPServer at 127.0.0.1, port 0,
    served from a thread; :meth:`call` is one request on a fresh
    connection: (status, content type, body bytes)."""

    def __init__(self, model, spf, **pool_kw):
        import threading
        from http.server import ThreadingHTTPServer

        from reazonspeech_tpu_torch.serving.http import make_app

        self.handler, self.pool = make_app(model, spf, executor="continuous", **pool_kw)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def call(self, method, path, body=None):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/octet-stream"} if body else {})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, resp.getheader("Content-Type"), data

    def close(self):
        """Stop accepting, then drain the pool."""
        self.server.shutdown()
        self.server.server_close()
        self.pool.close()


def concurrently(fns):
    """Call every fn at once, each on its own thread; their results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(fns)) as ex:
        return list(ex.map(lambda f: f(), fns))


def _lane0(trace):
    """A recorded search's first lane (row 0 of every recorded tensor)."""
    return [tuple(x[:1] for x in step) for step in trace]


def serving_near_tie(what, kind, model, pool_kw, wav, static):
    """Where the executor's answer differs from the same-shape
    MicroBatcher's (``static``, its (tokens, frames)): the request alone
    through a fresh pool of the same configuration, and the MicroBatcher's
    decode of it, both recorded; where the two differ, they must first
    differ at an fp32 near-tie under 1e-4, as same_decode allows. Greedy has
    no such allowance (its pool and batch run the same shapes). Returns the
    lone run's (tokens, frames), which the caller holds against the
    executor's answer among other requests (no lane leaks into another)."""
    import torch

    from reazonspeech_tpu_torch.serving import ContinuousBatcher

    check(kind in ("alsd", "graves", "maes"),
          f"{what}: differs from the same-shape MicroBatcher")
    rec_pool, rec_micro = [], []
    pool = ContinuousBatcher(model, **pool_kw)
    try:
        with recorded(kind, rec_pool):
            lone = pool.submit(wav).result(timeout=600)
    finally:
        pool.close()
    if tuple(lone) == tuple(static):
        return lone
    buf = np.zeros((pool.max_encode_batch, pool.max_samples), np.float32)
    buf[0, :len(wav)] = wav
    lens = np.zeros(pool.max_encode_batch, np.int32)
    lens[0] = len(wav)
    with recorded(kind, rec_micro):
        model.decode_batch(buf, lens)
    torch.cuda.synchronize()
    div = first_divergence(kind, _lane0(rec_pool), _lane0(rec_micro))
    check(div is not None, f"{what}: the answers differ but no recorded step does")
    step, _, slot, gap = div
    log(f"{what}: differs from the MicroBatcher's; first differing "
        f"{'step' if kind == 'alsd' else 'frame'} {step}, slot {slot}: fp32 score gap "
        f"{gap:.3g} between the two candidates (tol 1e-4)")
    check(gap < 1e-4, f"{what}: the answers differ beyond an fp32 near-tie (gap {gap})")
    return lone


def serve_flavor(what, name, model, spf, kind, kernels, pool_kw, shorts, long_w=None):
    """One flavor through the HTTP front over its ContinuousBatcher: the
    short requests and the long one (windowed by submit_long) posted at
    once, then the long one again on /transcribe_stream, /healthz and
    /metrics; the drain. Then the same requests through a MicroBatcher of
    the pool's encode shape (the long one as its windows, stitched by
    _window_keep), the same-shape A/B: equal answers, or an fp32 near-tie
    (:func:`serving_near_tie`). Fails on any 500, an unfinished drain, a
    busy lane after close(), or a kernel of ``kernels`` not launched in the
    executor's run."""
    import json

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.serving import MicroBatcher
    from reazonspeech_tpu_torch.serving.http import _result_json
    from reazonspeech_tpu_torch.utils import profiling

    front = HttpFront(model, spf, **pool_kw)
    pool = front.pool
    requests = list(shorts) + ([long_w] if long_w is not None else [])
    audio_s = sum(len(w) for w in requests) / SR
    try:
        pool.warmup(2.0)  # the executor thread's handles and pools
        segments0, since_ns = pool.segments, time.time_ns()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        answers = concurrently([lambda w=w: front.call("POST", "/transcribe", w.tobytes())
                                for w in requests])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stream = front.call("POST", "/transcribe_stream", long_w.tobytes()) \
            if long_w is not None else None
        health = front.call("GET", "/healthz")
        metrics = front.call("GET", "/metrics")
    finally:
        front.close()
    check(not pool._thread.is_alive(), f"{what}: the executor did not drain")
    check(pool.busy_lanes() == 0, f"{what}: a lane is busy after close()")
    bad = [(i, st, body[:200]) for i, (st, _, body) in enumerate(answers) if st != 200]
    check(not bad, f"{what}: requests failed: {bad}")
    check(health[0] == 200 and metrics[0] == 200, f"{what}: /healthz or /metrics failed")
    stats = json.loads(health[2])
    check(stats["requests_done"] >= len(requests) and stats["executor"] == "continuous",
          f"{what}: /healthz {stats}")
    check("reazonspeech_lane_occupancy" in metrics[2].decode(), f"{what}: /metrics lacks stats")
    log(f"{what}: launch counts in the executor's run {counts}")
    check(all(counts[k] > 0 for k in kernels),
          f"{what}: a kernel of the serving path was not launched: {counts}")
    got = [json.loads(body) for _, _, body in answers]

    # the same requests through the pool's encode shape, statically batched
    micro = MicroBatcher(model, fixed_shape=(pool.max_encode_batch, pool.max_samples))
    windows = []
    if long_w is not None:
        starts, chunk, overlap = pool._window_plan(len(long_w), None)
        windows = [long_w[st:st + chunk] for st in starts]
    try:
        t0 = time.perf_counter()
        static = [f.result(timeout=600) for f in [micro.submit(w) for w in
                                                   list(shorts) + windows]]
        static_wall = time.perf_counter() - t0
    finally:
        micro.close()
    torch.cuda.synchronize()
    near = 0
    for i, w in enumerate(shorts):
        if got[i] != _result_json(model, *static[i], spf):
            lone = serving_near_tie(f"{what} request {i}", kind, model, pool_kw, w, static[i])
            check(_result_json(model, *lone, spf) == got[i],
                  f"{what} request {i}: alone in the pool it decodes otherwise")
            near += 1
    if long_w is not None:
        keep = dict(starts=starts, chunk=chunk, overlap=overlap, w_len=len(long_w))
        parts = static[len(shorts):]
        if got[-1] != _result_json(model, *_stitch(pool, parts, keep), spf):
            lone = [serving_near_tie(f"{what} long request, window {j}", kind, model, pool_kw,
                                     win, part) for j, (win, part) in enumerate(zip(windows, parts))]
            check(_result_json(model, *_stitch(pool, lone, keep), spf) == got[-1],
                  f"{what}: the long request differs from its windows stitched")
            near += 1
        lines = [json.loads(x) for x in stream[2].decode().splitlines()]
        check(stream[0] == 200 and len(lines) == len(starts),
              f"{what}: /transcribe_stream gave {stream[0]}, {len(lines)} lines")
        check(sum((x["subwords"] for x in lines), []) == got[-1]["subwords"]
              and "".join(x["text"] for x in lines) == got[-1]["text"],
              f"{what}: the stream's lines differ from submit_long's answer")
    segs = pool.segments - segments0
    host_ms = sum(sp.seconds for sp in profiling.spans()
                  if sp.name == "serve.segment" and sp.start_ns >= since_ns) * 1e3 / max(segs, 1)
    log(f"{what} on {name}: {len(requests)} requests ({audio_s:.1f} audio-s; "
        f"{len(shorts)} short, {len(windows)} windows of the long one); executor "
        f"{wall:.3f} s wall, {audio_s / wall:.2f} audio-s/s; fixed-shape MicroBatcher "
        f"{static_wall:.3f} s wall, {audio_s / static_wall:.2f} audio-s/s on the same requests; "
        f"{segs} segments, host {host_ms:.2f} ms per segment; lane occupancy "
        f"{stats['lane_occupancy']}; latency p50 {stats['latency_s']['p50']} s, p95 "
        f"{stats['latency_s']['p95']} s; answers equal to the MicroBatcher's: "
        f"{len(requests) - near} of {len(requests)} (the rest fp32 near-ties)")


def _stitch(pool, parts, keep):
    """Window answers merged as submit_long merges them."""
    tokens, frames = [], []
    for i, (st, (toks, frs)) in enumerate(zip(keep["starts"], parts)):
        t, f = pool._window_keep(toks, frs, i=i, start=st, **keep)
        tokens += t
        frames += f
    return tokens, frames


def serving_kernels(model, pool_kw):
    """The kernels a pool's encode tick (the packed route at its window's
    T) and its beam segments launch."""
    import types

    from reazonspeech_tpu_torch.models.fastconformer import attention_route
    from reazonspeech_tpu_torch.serving import ContinuousBatcher

    conv = {"batch_norm": "fused_conv_module_ln", "layer_norm": "fused_conv_module_ln_layer"}
    t_buf = ContinuousBatcher.host_frames(types.SimpleNamespace(model=model),
                                          int(pool_kw["max_seconds"] * SR))
    route = attention_route(model.enc_cfg, t_buf)
    check(route == "packed", f"serving: attention route {route} at T={t_buf}")
    return PACKED_ROUTE_KERNELS + (conv[model.enc_cfg.conv_norm], "topm_logsoftmax")


def serving_phase(name):
    """The serving stack at each flavor's full published width and depth in
    its GPU serving configuration, random weights from its seed: nemo ALSD
    beam 4 (8 lanes, 32 steps a segment, 20 s windows, 4 encodes a tick)
    under 8 requests of 2-20 s and one of 45 s; k2 greedy (8 lanes, 8
    encodes a tick) under 5 requests of 3-20 s; espnet Graves beam 20 (4
    lanes, 4 encodes a tick: the MicroBatcher's shapes) with the joint's
    blank raised as in the espnet phase, under 3 requests of 2-5 s."""
    import gc

    import torch

    from reazonspeech_tpu_torch.espnet.asr import load_model as espnet_load
    from reazonspeech_tpu_torch.k2.asr import load_model as k2_load
    from reazonspeech_tpu_torch.models.zipformer import ZipformerConfig
    from reazonspeech_tpu_torch.nemo.asr import load_model as nemo_load

    t_phase = time.perf_counter()
    encoder_kernels = serving_kernels
    model = nemo_load(device="cuda", checkpoint="random")
    check(model.enc_cfg.d_model == 1024 and model.enc_cfg.num_layers == 24
          and model.decode_cfg.topk_impl == "pallas" and model.decode_cfg.beam_size == 4,
          "serving: nemo is not the xlarge ALSD beam 4 serving configuration")
    kw = dict(n_lanes=8, frames_per_segment=32, max_seconds=20.0, max_encode_batch=4)
    shorts = [speech_like(sec, seed=300 + i) for i, sec in enumerate((2, 4, 7, 10, 13, 16, 19, 20))]
    serve_flavor("serving nemo ALSD", name, model, 0.08, "alsd", encoder_kernels(model, kw), kw,
                 shorts, long_w=speech_like(45.0, seed=310))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = k2_load(device="cuda", checkpoint="random")
    cfg, large = model.enc_cfg, ZipformerConfig.large()
    check((cfg.num_layers, cfg.encoder_dim, cfg.attn_impl) ==
          (large.num_layers, large.encoder_dim, "pallas"),
          "serving: k2 is not ZipformerConfig.large() on the shared-attention kernels")
    kw = dict(n_lanes=8, frames_per_segment=32, max_seconds=20.0, max_encode_batch=8)
    shorts = [speech_like(sec, seed=320 + i) for i, sec in enumerate((3, 6, 11, 15, 20))]
    serve_flavor("serving k2 greedy", name, model, 0.04, "greedy", ("shared_rel_attention",),
                 kw, shorts)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = espnet_load(device="cuda", checkpoint="random")
    check(model.enc_cfg.d_model == 512 and model.enc_cfg.num_layers == 12
          and model.decode_cfg.beam_size == 20 and model.decode_cfg.topk_impl == "pallas",
          "serving: espnet is not the full-width Graves beam 20 serving configuration")
    model.params["joint"]["out"]["b"][0] += ESPNET_BLANK_BIAS
    kw = dict(n_lanes=4, frames_per_segment=32, max_seconds=20.0, max_encode_batch=4)
    shorts = [speech_like(sec, seed=330 + i) for i, sec in enumerate((2, 3.5, 5))]
    serve_flavor("serving espnet Graves", name, model, 0.04, "graves",
                 encoder_kernels(model, kw), kw, shorts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")



# --- phase 10: the decode options, v1 and 1seg ---------------------------------

MAES_KERNELS = ("relpos_attention", "relpos_attention_blockwise", "fused_conv_module_ln_layer",
                "topm_logsoftmax")


def maes_frame_launches(model, enc, el, frames=4):
    """Device launches per mAES frame: torch.profiler over a decode of the
    first ``frames`` encoder frames (the encoder projection and the fresh
    state included), over the frames."""
    from reazonspeech_tpu_torch.decoding.transducer_maes import maes_beam_decode

    head = (enc[:, :frames].contiguous(), el.clamp(max=frames))
    p = model.params
    items = device_items(lambda: maes_beam_decode(p["predictor"], p["joint"], *head,
                                                  model.rnnt_cfg, model.decode_cfg), 1)
    check(items, "mAES: the profiler recorded no device kernel in the frames")
    return sum(c for _, _, c in items) / frames


def maes_phase(name, rand):
    """espnet decoding="maes" (beam 20 on the top-m kernel) at full width,
    the blank logit +12: decode_batch of the espnet phase's four 10 s
    windows (the 22 s bucket) and decode_single of its 45 s input, the tokens
    against the
    top-m twin's (or an fp32 near-tie), beside Graves beam 20 on the same
    inputs; row 3 at mAES's shape (R = 4 lanes x beam 20, m = 22); then the
    executor over it behind the HTTP front. Returns the model."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.transducer_maes import MAESBeamConfig, maes_beam_decode
    from reazonspeech_tpu_torch.espnet import asr

    model = asr.load_model(device="cuda", checkpoint="random", decoding="maes")
    check(model.enc_cfg.d_model == 512 and model.enc_cfg.num_layers == 12
          and model.decode_cfg == MAESBeamConfig(beam_size=20, topk_impl="pallas"),
          "decode_options: espnet maes is not the full-width mAES beam 20 on the top-m kernel")
    model.params["joint"]["out"]["b"][0] += ESPNET_BLANK_BIAS
    buf, lens, single = espnet_inputs()
    sbuf, slens = model._bucket(single)
    model.decode_single(speech_like(2.0, seed=49))
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    batch = model.decode_batch(buf, lens)
    t1 = time.perf_counter()
    one = model.decode_batch(sbuf, slens)
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    log(f"mAES path: launch counts {counts}")
    check(all(counts[k] > 0 for k in MAES_KERNELS), f"an mAES path kernel was not launched: {counts}")
    check(batch[3].tolist() == [287] * 4, f"mAES decode_batch: encoder lengths {batch[3]}")
    for out in (batch, one):
        for i in range(out[0].shape[0]):
            fr = out[1][i, :int(out[2][i])].tolist()
            check(fr == sorted(fr) and all(0 <= f < int(out[3][i]) for f in fr),
                  "mAES: emission frames out of order or range")
    frames_run = int(batch[3].max()) + int(one[3][0])
    with torch.inference_mode():
        enc, el = _espnet_encode(model, buf, lens)
        per_frame = maes_frame_launches(model, enc, el)
        # the searches' best scores too (these weights emit few tokens or
        # none): the kernel's and the twin's within fp32 rounding
        pp, jp = model.params["predictor"], model.params["joint"]
        got_s = maes_beam_decode(pp, jp, enc, el, model.rnnt_cfg, model.decode_cfg)[3]
        with plain_twins(("topm_logsoftmax",)):
            want_s = maes_beam_decode(pp, jp, enc, el, model.rnnt_cfg, model.decode_cfg)[3]
    rel = ((got_s - want_s).abs() / want_s.abs()).max().item()
    log(f"mAES best scores, 4 x {ESPNET_WINDOW_S:.0f} s windows, top-m kernel vs twin: "
        f"{got_s.tolist()} "
        f"against {want_s.tolist()}, relative difference {rel:.3g} (tol 1e-5)")
    check(rel <= 1e-5, f"mAES: best scores differ from the twin's by {rel} relative")
    g = ESPNET_GRAVES  # empty where the espnet phase did not run (the phase alone)
    graves = (lambda key, audio: f"{g[key]:.3f} s, {audio / g[key]:.2f} audio-s/s"
              if key in g else "not measured in this run")
    audio = 4 * ESPNET_WINDOW_S
    log(f"mAES beam 20 decode_batch 4 x {ESPNET_WINDOW_S:.0f} s windows (B=4, T=549): "
        f"{t1 - t0:.3f} s wall, {audio / (t1 - t0):.2f} audio-s/s, tokens {batch[2].tolist()}; "
        f"Graves beam 20 on the same windows (espnet phase): {graves('batch_s', audio)}, tokens "
        f"{g.get('batch_tokens')}; on {name}")
    log(f"mAES beam 20 decode_single 45 s (T=1149): {t2 - t1:.3f} s wall, "
        f"{45.0 / (t2 - t1):.2f} audio-s/s, {int(one[2][0])} tokens; Graves beam 20 on a "
        f"{ESPNET_SINGLE_S:.0f} s input (espnet phase): {graves('single_s', ESPNET_SINGLE_S)}, "
        f"{g.get('single_tokens')} tokens")
    log(f"mAES: {frames_run} frame bodies in the two calls, {per_frame:.1f} device launches "
        f"a frame (B=4, a 4-frame decode with its set-up), row-3 launches "
        f"{counts['topm_logsoftmax']} ({counts['topm_logsoftmax'] / frames_run:.2f} a frame); "
        f"host {(t2 - t0) * 1e3 / frames_run:.3f} ms a frame")

    for what, wav, wlens, got in ((f"4 x {ESPNET_WINDOW_S:.0f} s windows", buf, lens, batch),
                                  ("45 s", sbuf, slens, one)):
        def rerun(twins, wav=wav, wlens=wlens):
            with plain_twins(("topm_logsoftmax",)) if twins else contextlib.nullcontext():
                return model.decode_batch(wav, wlens)

        same_decode(f"mAES beam 20, {what}", got, rerun(True), rerun, "maes")

    logits = rand(80, 2182, scale=3.0, dtype=torch.float32)
    row = _compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                   (logits, 22, 0), 1e-4, iters=200, label="mAES, R=80, V=2182, m=22",
                   flops=flops_topm)
    topm_yardstick(row, "mAES, R=80, V=2182, m=22", logits, 22, 0, strict=False)

    kw = dict(n_lanes=4, frames_per_segment=32, max_seconds=20.0, max_encode_batch=4)
    shorts = [speech_like(sec, seed=330 + i) for i, sec in enumerate((2, 3.5, 5))]
    serve_flavor("decode_options espnet mAES executor", name, model, 0.04, "maes",
                 serving_kernels(model, kw), kw, shorts)
    alone = [model.decode_single(w) for w in shorts]
    log(f"mAES executor requests: tokens {[len(t) for t, _ in alone]} alone by decode_single "
        f"(its own 2 s-grid bucket; the gate above is the pool's encode shape)")
    return model


def multipop_phase(name, rand):
    """Graves beam 20 (espnet, full width, blank +12) on four 3 s windows
    (B=4 in a 4 s buffer: T=99, 74 valid frames; the phase's cut, Graves
    runs ~2.7 audio-s/s on these weights) at multipop 1, 4 and 8, with the default impls (row 3) and
    with joint_impl/lstm_impl="pallas" (rows 12 and 13 at R = 4 x M): the
    tokens against multipop 1's (or an fp32 near-tie), rounds a frame,
    launches a round, wall; then rows 3, 12 and 13 at R = 16 and 32 beside
    their yardsticks."""
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.decoding.transducer_graves import graves_beam_decode_stats
    from reazonspeech_tpu_torch.espnet import asr

    model = asr.load_model(device="cuda", checkpoint="random")
    check(model.decode_cfg.beam_size == 20 and model.rnnt_cfg.pred_hidden == 256,
          "decode_options: espnet is not Graves beam 20 with pred_hidden 256")
    model.params["joint"]["out"]["b"][0] += ESPNET_BLANK_BIAS
    buf = np.zeros((4, 4 * SR), np.float32)
    for i in range(4):
        buf[i, :3 * SR] = speech_like(3.0, seed=70 + i)
    lens = np.full(4, 3 * SR, np.int32)
    p, rc = model.params, model.rnnt_cfg
    with torch.inference_mode():
        enc, el = _espnet_encode(model, buf, lens)
        lane_frames = int(el.sum())
        for label, impls, kernels in (
                ("topk_impl=pallas (the serving default)", {}, ("topm_logsoftmax",)),
                ("joint_impl/lstm_impl=pallas", dict(joint_impl="pallas", lstm_impl="pallas"),
                 STEP_KERNELS)):
            runs = {}
            for m in (1, 4, 8):
                cfg = replace(model.decode_cfg, multipop=m, **impls)
                graves_beam_decode_stats(p["predictor"], p["joint"], enc[:, :2], el.clamp(max=2),
                                         rc, cfg)  # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                *out, pmax, ptot, host = graves_beam_decode_stats(p["predictor"], p["joint"],
                                                                  enc, el, rc, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = ops.launch_counts()
                check(all(counts[k] > 0 for k in kernels),
                      f"Graves multipop {m} ({label}): a kernel was not launched: {counts}")
                runs[m] = [out[i].cpu().numpy() for i in (0, 1, 2, 4)]
                per_round = graves_pop_launches(p, rc, cfg, enc, el)
                log(f"Graves beam 20 multipop {m}, {label}, B=4 x 3 s (T={enc.shape[1]}): "
                    f"{wall:.3f} s wall, {12.0 / wall:.2f} audio-s/s on {name}; "
                    f"{int(ptot.sum()) / lane_frames:.2f} pops a lane-frame, "
                    f"{host['pops_issued'] / host['frames']:.2f} "
                    f"{'pops' if m == 1 else 'rounds'} issued a frame step, {per_round:.1f} "
                    f"device launches a {'pop' if m == 1 else 'round'} (a 4-frame decode, "
                    f"compaction included); launches {dict((k, counts[k]) for k in kernels)}; "
                    f"saturated lanes {int(out[4].sum())}; tokens {out[2].tolist()}")
            for m in (4, 8):
                def rerun(serial, m=m):
                    cfg = replace(model.decode_cfg, multipop=1 if serial else m, **impls)
                    out = graves_beam_decode_stats(p["predictor"], p["joint"], enc, el, rc, cfg)
                    return [out[i].cpu().numpy() for i in (0, 1, 2, 4)]

                # the default joint's products are bf16 (at B x M rows against B):
                # a near-tie there is 2 bf16 ulps of a logit up to 16 (the blank's)
                same_decode(f"Graves beam 20 multipop {m}, {label}", runs[m], runs[1], rerun,
                            "graves", versus=f"at multipop {m} == at multipop 1",
                            tol=1e-4 if impls else 0.125)

    for r in (16, 32):
        logits = rand(r, 2182, scale=3.0, dtype=torch.float32)
        row = _compare("topm_logsoftmax", ops.topm_logsoftmax, ops.topm_logsoftmax_plain,
                       (logits, 20, 0), 1e-4, iters=200, label=f"multipop, R={r}, V=2182, m=20",
                       flops=flops_topm)
        topm_yardstick(row, f"multipop, R={r}, V=2182, m=20", logits, 20, 0, strict=False)
        args = _joint_args(rand, r, 256, 2182, 0, "tanh", 20)
        row = _compare("joint_topm", ops.joint_topm, ops.joint_topm_plain, args, 1e-5, iters=200,
                       kwargs=dict(activation="tanh", compute_dtype="float32"),
                       label=f"multipop, R={r}, H=J=256, V=2182, m=20", flops=flops_joint)
        joint_yardstick(row, f"multipop, R={r}", args, "tanh", strict=False)
        h, f32 = 256, torch.float32
        w_ih, w_hh = (rand(h, 4 * h, scale=h ** -0.5, dtype=f32) for _ in range(2))
        bias, x = rand(4 * h, scale=0.1, dtype=f32), rand(r, h, dtype=f32)
        hp, cp = rand(r, h, scale=0.5, dtype=f32), rand(r, h, dtype=f32)
        w_ih_t, w_hh_t, zero = w_ih.t().contiguous(), w_hh.t().contiguous(), torch.zeros_like(bias)
        _compare("lstm_cell_step", ops.lstm_cell_step, ops.lstm_cell_step_plain,
                 (w_ih, w_hh, bias, x, hp, cp), (1e-5, 1e-5), iters=200,
                 kwargs=dict(compute_dtype="float32"), label=f"multipop, R={r}, H=256",
                 flops=flops_lstm,
                 library=lambda: torch.lstm_cell(x, (hp, cp), w_ih_t, w_hh_t, bias, zero))
    del model


@contextlib.contextmanager
def greedy_recorded(trace, count):
    """Count the greedy loop's iterations into ``count[0]``; where ``trace``
    is a list, also append before each iteration every lane's (frame clock,
    emissions, gap between the two largest joint logits at its frame, the
    largest logit's magnitude): the decision the iteration takes at
    frame_window 1."""
    import torch

    from reazonspeech_tpu_torch.decoding import rnnt_greedy as rg
    from reazonspeech_tpu_torch.models.rnnt import joint_step_from_enc_proj

    make = rg._make_body

    def recording(pp, jp, enc_proj, enc_lengths, emit_cap, u_max, rnnt_cfg, cfg):
        active, body = make(pp, jp, enc_proj, enc_lengths, emit_cap, u_max, rnnt_cfg, cfg)
        rows = torch.arange(enc_proj.shape[0], device=enc_proj.device)

        def step(s):
            count[0] += 1
            if trace is not None:
                at = enc_proj[rows, s.time_idx.clamp(max=enc_proj.shape[1] - 1)]
                top = joint_step_from_enc_proj(jp, at, s.pred_out, rnnt_cfg).sort(
                    dim=-1, descending=True).values
                trace.append((s.time_idx.cpu(), s.counts.cpu(), (top[:, 0] - top[:, 1]).cpu(),
                              top[:, 0].abs().cpu()))
            return body(s)

        return active, step

    rg._make_body = recording
    try:
        yield
    finally:
        rg._make_body = make


def greedy_near_tie(what, model, buf, lens, got, want):
    """Where frame_window W decodes otherwise than window 1 (``want``):
    window 1 again, recording each decision's two best logits; at each
    differing lane's first differing emission (frame f after j tokens: the
    state both runs reach alike), window 1's decision there must be a tie
    within 2 bf16 ulps of its largest logit (the joint's bf16 products
    summed in another order over [B, W, J] rows)."""
    trace = []
    with greedy_recorded(trace, [0]):
        again = model.decode_batch(buf, lens)
    check(_same(again, want), f"{what}: window 1 does not repeat itself")
    tokens, frames, counts = got[:3]
    for b in range(tokens.shape[0]):
        a = list(zip(want[0][b, :want[2][b]], want[1][b, :want[2][b]]))
        w = list(zip(tokens[b, :counts[b]], frames[b, :counts[b]]))
        if a == w:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, w)) if x != y), min(len(a), len(w)))
        f = min(a[j][1] if j < len(a) else 1 << 30, w[j][1] if j < len(w) else 1 << 30)
        hit = [(gap[b].item(), mag[b].item()) for t, c, gap, mag in trace
               if int(t[b]) == f and int(c[b]) == j]
        check(hit, f"{what}: lane {b}: window 1 never decided at frame {f} after {j} tokens")
        gap, mag = hit[0]
        tol = 2.0 * 2.0 ** (np.floor(np.log2(mag)) - 7)
        log(f"{what}: lane {b} first differs at emission {j}, frame {f}: window 1's two best "
            f"logits {gap:.3g} apart (tol 2 bf16 ulps, {tol:.3g})")
        check(gap <= tol, f"{what}: lane {b} differs beyond a bf16 near-tie (gap {gap})")


def frame_window_phase(name):
    """k2 greedy at ZipformerConfig.large() (full width and depth, random
    weights) on transcribe_batch of 4 x 30 s at frame_window 1, 4 and 8:
    the tokens against window 1's (or a bf16 near-tie), loop iterations and
    wall."""
    from dataclasses import asdict, replace

    import torch

    from reazonspeech_tpu_torch.core.audio import norm_audio, pad_audio
    from reazonspeech_tpu_torch.k2 import asr
    from reazonspeech_tpu_torch.k2.asr.model import BUCKET_SAMPLES
    from reazonspeech_tpu_torch.k2.asr.transcribe import PAD_SECONDS

    model = asr.load_model(device="cuda", checkpoint="random")
    check(model.enc_cfg.encoder_dim == asr.model.ZipformerConfig.large().encoder_dim
          and model.decode_cfg.frame_window == 1, "decode_options: k2 is not the large greedy")
    batch = [asr.audio_from_numpy(speech_like(30.0, seed=30 + i), SR) for i in range(4)]
    waves = [pad_audio(norm_audio(a), PAD_SECONDS).waveform for a in batch]
    lens = np.array([len(w) for w in waves], np.int32)
    buf = np.zeros((4, -(-int(lens.max()) // BUCKET_SAMPLES) * BUCKET_SAMPLES), np.float32)
    for i, w in enumerate(waves):
        buf[i, :len(w)] = w
    asr.transcribe_batch(model, batch[:1])
    torch.cuda.synchronize()
    runs = {}
    for w in (1, 4, 8):
        m = replace(model, decode_cfg=replace(model.decode_cfg, frame_window=w))
        iters = [0]
        with greedy_recorded(None, iters):
            t0 = time.perf_counter()
            res = asr.transcribe_batch(m, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[w] = (m.decode_batch(buf, lens), [asdict(r) for r in res])
        log(f"k2 greedy frame_window {w}, transcribe_batch 4 x 30 s: {wall:.3f} s wall, "
            f"{120.0 / wall:.2f} audio-s/s on {name}; {iters[0]} loop iterations issued; "
            f"tokens {runs[w][0][2].tolist()}")
    for w in (4, 8):
        if _same(runs[w][0], runs[1][0]):
            check(runs[w][1] == runs[1][1], f"k2 frame_window {w}: results differ, tokens not")
            log(f"k2 greedy frame_window {w}: tokens and results == window 1's")
        else:
            greedy_near_tie(f"k2 greedy frame_window {w}", model, buf, lens, runs[w][0],
                            runs[1][0])
    del model


def v1_oneseg_phase(model, name):
    """The v1 and 1seg pipelines on the espnet container on the card (the
    mAES one: its decode is the faster): v1.transcribe of a 45 s input
    yields ordered captions over the input, past its first window; the 1seg
    CTCSegmentationAligner on a 20 s input with a text in the vocabulary
    returns its segment, and ctc_probs there is within relative L2 5e-2 of
    the plain-twin encoder's."""
    import torch

    from reazonspeech_tpu_torch import oneseg, ops, v1

    audio = speech_like(45.0, seed=80)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    caps = list(v1.transcribe(audio, model))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"v1 path: launch counts {counts}")
    check(all(counts[k] > 0 for k in PACKED_ROUTE_KERNELS + ("topm_logsoftmax",)),
          f"a kernel of the v1 path was not launched: {counts}")
    spans = [(c.start_seconds, c.end_seconds) for c in caps]
    # every window yields a caption (one of its whole span where its decode
    # is empty, as on these weights with the blank +12): the first and the
    # last windows' captions bound the input
    check(caps and spans[0][0] < 20.0 and spans[-1][1] > 25.0
          and all(0 <= a <= b <= 45.0 + 1e-6 for a, b in spans)
          and [a for a, _ in spans] == sorted(a for a, _ in spans),
          f"v1: captions out of order or short of the input: {spans[:8]}")
    log(f"v1.transcribe 45 s: {wall:.3f} s wall, {45.0 / wall:.2f} audio-s/s on {name}; "
        f"{len(caps)} captions over {spans[0][0]:.2f}-{spans[-1][1]:.2f} s, "
        f"{sum(len(c.text) for c in caps)} characters")

    clip = speech_like(20.0, seed=81)
    t0 = time.perf_counter()
    seg = oneseg.CTCSegmentationAligner(model)(clip, "こんにちは")
    wall = time.perf_counter() - t0
    check(len(seg.segments) == 1 and 0 <= seg.segments[0][0] < seg.segments[0][1] <= 20.0
          and np.isfinite(seg.segments[0][2]), f"1seg aligner: segments {seg.segments}")
    lpz = model.ctc_probs(clip)
    with plain_twins():
        twin = model.ctc_probs(clip)
    torch.cuda.synchronize()
    rel = float(np.linalg.norm(lpz - twin) / np.linalg.norm(twin))
    log(f"1seg CTCSegmentationAligner, 20 s: {wall:.3f} s wall, segment "
        f"{tuple(round(x, 3) for x in seg.segments[0])}; ctc_probs kernels vs plain twins: "
        f"relative L2 {rel:.3g} (tol 5e-2)")
    check(rel <= 5e-2, f"1seg ctc_probs: relative L2 {rel} against the plain twins")


def decode_options_phase(name):
    """Phase 10: the decode options the earlier phases do not run (espnet
    mAES one-shot and in the executor, Graves multipop, k2 greedy
    frame_window) and the v1 and 1seg pipelines, at full published width."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(14)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(device="cuda", dtype=dtype)

    model = maes_phase(name, rand)
    v1_oneseg_phase(model, name)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    multipop_phase(name, rand)
    gc.collect()
    torch.cuda.empty_cache()
    frame_window_phase(name)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"decode_options phase: {time.perf_counter() - t_phase:.1f} s")


# --- phase 11: the AVSR family (AV-HuBERT base) --------------------------------

AVSR_FPS = 25  # fused feature frames a second (4 stacked 100 Hz fbank frames)
AVSR_MAX_LENGTH = 128
AVSR_BATCH, AVSR_SECONDS = 16, 4.0  # the batch generate's utterances


def avsr_request(rng, seconds, audio=True, video=True):
    """One utterance's model inputs from a numpy seed: stacked fbank features
    [T, 104] and normalized mouth ROIs [T, 88, 88], T = 25 a second."""
    t = int(seconds * AVSR_FPS)
    a = rng.standard_normal((t, 104)).astype(np.float32) if audio else None
    v = rng.standard_normal((t, 88, 88)).astype(np.float32) if video else None
    return a, v


def avsr_alone(model, a, v, beams, max_length=AVSR_MAX_LENGTH):
    """The request alone (batch 1 at its own length, a missing modality
    zero-filled as the AVSR batcher fills it): its tokens, trimmed at the
    first EOS, and the padded arrays."""
    t = len(a) if a is not None else len(v)
    audio = np.zeros((1, t, model.config.audio_feat_dim), np.float32)
    video = np.zeros((1, t, 88, 88), np.float32)
    if a is not None:
        audio[0] = a
    if v is not None:
        video[0] = v
    toks = model.generate(audio=audio, video=video, lengths=np.array([t]), num_beams=beams,
                          max_length=max_length)[0].cpu().numpy()
    hits = np.nonzero(toks == model.config.eos_token_id)[0]
    return toks[: int(hits[0]) if hits.size else len(toks)].tolist(), (audio, video, [t])


@contextlib.contextmanager
def avsr_recorded(trace):
    """Append to ``trace``, on the host, each cached decoder step's logits
    (what greedy picks from) and each beam step's top-2k values and indices
    (what the beam search picks from)."""
    from reazonspeech_tpu_torch.avsr import model as am

    def steps(step):
        def recording(self, *args):
            logits = step(self, *args)
            trace.append(("logits", logits.float().cpu()))
            return logits
        return recording

    def tops(top):
        def recording(cand, n):
            vals, idx = top(cand, n)
            trace.append(("top", vals.cpu(), idx.cpu()))
            return vals, idx
        return recording

    with swapped(am._Decoder, "step", steps), swapped(am, "_top_candidates", tops):
        yield trace


def avsr_first_divergence(rec_a, rec_b, row_a, row_b):
    """(step, fp32 gap) at the first decode step where row ``row_a`` of one
    recorded search and row ``row_b`` of the other pick differently: greedy,
    the gap between the two picks' logits in the first run; beam, the gap
    between the two runs' values at the first rank whose candidate differs.
    None where every step agrees."""
    kind = "top" if any(r[0] == "top" for r in rec_a) else "logits"
    rec_a = [r for r in rec_a if r[0] == kind]
    rec_b = [r for r in rec_b if r[0] == kind]
    for i, (a, b) in enumerate(zip(rec_a, rec_b)):
        if kind == "logits":
            la, lb = a[1][row_a], b[1][row_b]
            pa, pb = int(la.argmax()), int(lb.argmax())
            if pa != pb:
                return i, abs(float(la[pa]) - float(la[pb]))
        else:
            diff = (a[2][row_a] != b[2][row_b]).nonzero()
            if len(diff):
                j = int(diff[0, 0])
                return i, abs(float(a[1][row_a, j]) - float(b[1][row_b, j]))
    return None


def same_avsr(what, got, want, rerun_a, rerun_b, row_a=0, row_b=0, tol=1e-4):
    """Token lists ``got`` and ``want`` must be equal; where they differ,
    both runs are repeated recording their searches (``got`` is row
    ``row_a`` of the first, ``want`` row ``row_b`` of the second) and the
    first differing step's two candidates must lie within ``tol`` in fp32 (a
    near-tie that two summation orders break differently). True where equal."""
    if got == want:
        return True
    rec_a, rec_b = [], []
    with avsr_recorded(rec_a):
        rerun_a()
    with avsr_recorded(rec_b):
        rerun_b()
    div = avsr_first_divergence(rec_a, rec_b, row_a, row_b)
    check(div is not None, f"{what}: the tokens differ but no recorded step does")
    step, gap = div
    log(f"{what}: tokens differ; first differing step {step}: fp32 gap {gap:.3g} between the "
        f"two candidates (tol {tol:g})")
    check(gap < tol, f"{what}: the tokens differ beyond a near-tie (gap {gap})")
    return False


def kernel_profile(fn, tries=3):
    """(device busy ms, device launches, the largest items) of one fn()
    call, already warmed: torch.profiler with the CUDA activity alone (a
    decode loop issues ~80,000 kernels, whose CPU-side events would take the
    profiler minutes), taken again up to ``tries`` times where it records no
    kernel, then device_items' CPU and CUDA profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        items = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if items:
            break
    else:
        items = device_items(fn, 1)
    check(items, "the profiler recorded no device kernel")
    return (sum(ms for _, ms, _ in items), sum(c for _, _, c in items),
            sorted(items, key=lambda x: -x[1])[:4])


def avsr_batch_phase(model, name):
    """Beam 5 and greedy generate on B=16 utterances of 4 s, audio-visual, at
    max_length 128 (inputs staged on the card): wall and audio-s/s, wall and
    device ms per decode step, device launches per step, the device split
    into the ResNet3D, the rest of the encoder and the decode loop, and the
    device ms of the beam's cache reorder and of the cross-attention K/V
    projections, which every step recomputes."""
    import torch

    from reazonspeech_tpu_torch.avsr import model as am
    from reazonspeech_tpu_torch.avsr.resnet3d import resnet3d_apply
    from reazonspeech_tpu_torch.models.layers import dense

    cfg = model.config
    b, seconds = AVSR_BATCH, AVSR_SECONDS
    t = int(seconds * AVSR_FPS)
    rng = np.random.default_rng(150)
    a = torch.from_numpy(rng.standard_normal((b, t, 104)).astype(np.float32)).to(model.device)
    v = torch.from_numpy(rng.standard_normal((b, t, 88, 88)).astype(np.float32)).to(model.device)
    with torch.inference_mode():
        enc, mask = model.encoder(a, v)
        resnet = kernel_profile(lambda: resnet3d_apply(model.params["video_resnet"], v))[0]
        encoder = kernel_profile(lambda: model.encoder(a, v))[0]
        enc_wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encoder(a, v)
            torch.cuda.synchronize()
            enc_wall.append(time.perf_counter() - t0)
        enc_wall = sorted(enc_wall)[1]
        check(tuple(enc.shape) == (b, t, cfg.hidden_size) and bool(torch.isfinite(enc).all()),
              f"avsr encoder: shape {tuple(enc.shape)} or non-finite values")
        log(f"avsr encoder on {name}: B={b} x {seconds:g} s (T={t}), {resnet:.3f} device ms in "
            f"the ResNet3D, {encoder - resnet:.3f} in the rest of the encoder, "
            f"{1e3 * enc_wall:.2f} wall ms")
        for beams in (5, 1):
            label = "beam 5" if beams > 1 else "greedy"
            steps = []
            with swapped(am._Decoder, "step",
                         lambda step: lambda self, *args: steps.append(1) or step(self, *args)):
                model.generate(a, v, num_beams=beams, max_length=AVSR_MAX_LENGTH)  # warm
                torch.cuda.synchronize()
                steps.clear()
                t0 = time.perf_counter()
                toks = model.generate(a, v, num_beams=beams, max_length=AVSR_MAX_LENGTH)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n = len(steps)
            check(tuple(toks.shape) == (b, AVSR_MAX_LENGTH)
                  and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                  f"avsr {label}: tokens of shape {tuple(toks.shape)} or out of the vocabulary")
            if beams > 1:
                loop = lambda: am.beam_generate(model.params, cfg, enc, mask, 5,  # noqa: E731
                                                AVSR_MAX_LENGTH)
            else:
                loop = lambda: am.greedy_generate(model.params, cfg, enc, mask,  # noqa: E731
                                                  AVSR_MAX_LENGTH)
            busy, launches, top = kernel_profile(loop)
            loop_s = wall - enc_wall
            log(f"avsr generate {label} on {name}: B={b} x {seconds:g} s, max_length "
                f"{AVSR_MAX_LENGTH}, {n} decode steps: wall {wall:.3f} s "
                f"({b * seconds / wall:.2f} audio-s/s), the decode loop {loop_s:.3f} s "
                f"= {1e3 * loop_s / n:.2f} host ms a step (the loop's wall over its steps); "
                f"device busy {busy:.3f} ms in the loop ({busy / n:.3f} a step, "
                f"{100 * busy / 1e3 / loop_s:.1f} % of its wall), {launches / n:.1f} device "
                f"launches a step; largest: " + "; ".join(f"{k[:48]} {ms:.3f} ms x{c:.0f}"
                                                          for k, ms, c in top))

        # the two pieces of the beam step the JAX package's semantics keep
        layers = am._layers(model.params["dec_layers"])
        enc_x = enc.repeat_interleave(5, dim=0)
        kc = torch.zeros((len(layers), b * 5, AVSR_MAX_LENGTH, cfg.decoder_hidden_size),
                         device=model.device)
        vc = torch.zeros_like(kc)
        gflat = torch.randint(0, b * 5, (b * 5,), device=model.device)

        def reorder():
            return kc.index_select(1, gflat), vc.index_select(1, gflat)

        def cross():
            return [(dense(lp["cross_attn"]["k"], enc_x), dense(lp["cross_attn"]["v"], enc_x))
                    for lp in layers]

        reorder()
        cross()
        reorder_ms = kernel_profile(lambda: [reorder() for _ in range(10)])[0] / 10
        cross_ms = kernel_profile(lambda: [cross() for _ in range(10)])[0] / 10
        log(f"avsr beam step pieces on {name}: the cache reorder (2 x [{len(layers)}, {b * 5}, "
            f"{AVSR_MAX_LENGTH}, {cfg.decoder_hidden_size}] fp32 gathers) "
            f"{reorder_ms:.4f} device ms a step; the cross-attention K/V projections of the "
            f"encoder output ({len(layers)} layers x 2 of [{b * 5}, {t}, {cfg.hidden_size}] "
            f"x [{cfg.hidden_size}, {cfg.decoder_hidden_size}]) {cross_ms:.4f} device ms a step")


def avsr_cpu_check(model, name):
    """On a 1 x 1 s audio-visual input: the encoder against the port on the
    CPU on the same weights (relative L2 <= 1e-4, fp32 without TF32), and
    greedy and beam-5 tokens at max_length 8 against the CPU's (equal, or
    the first differing step's candidates within 1e-4); again with EOS's row
    of the tied embedding 1.5 x that of the token greedy emits most, so that
    EOS ranks and the beam's banking pool runs. Returns the short input."""
    import torch

    from reazonspeech_tpu_torch.avsr import AVHubertForConditionalGeneration
    from reazonspeech_tpu_torch.avsr import model as am

    cfg = model.config
    a, v = avsr_request(np.random.default_rng(151), 1.0)
    short = (a[None], v[None])
    cpu = AVHubertForConditionalGeneration(config=cfg,
                                           params=am._tree_to_device(model.params, "cpu"))
    got, _ = model.encoder(*short)
    want, _ = cpu.encoder(*short)
    err = float(torch.linalg.norm(got.cpu().double() - want.double())
                / torch.linalg.norm(want.double()))
    log(f"avsr encoder on {name} against the CPU (1 x 1 s, T=25): relative L2 {err:.3g}")
    check(err <= 1e-4, f"avsr encoder: relative L2 {err} against the CPU")

    greedy = model.generate(*short, num_beams=1, max_length=8)[0].tolist()
    twin = max(set(greedy), key=greedy.count)
    scaled = dict(model.params, embed_tokens={"table": model.params["embed_tokens"]["table"]
                                              .clone()})
    scaled["embed_tokens"]["table"][cfg.eos_token_id] = \
        scaled["embed_tokens"]["table"][twin] * 1.5
    for label, gpu_model in (("random weights", model),
                             (f"EOS = 1.5 x token {twin}",
                              AVHubertForConditionalGeneration(config=cfg, params=scaled))):
        cpu_model = AVHubertForConditionalGeneration(
            config=cfg, params=am._tree_to_device(gpu_model.params, "cpu"))
        for beams in (1, 5):
            run_gpu = lambda: gpu_model.generate(*short, num_beams=beams,  # noqa: E731
                                                 max_length=8)[0].tolist()
            run_cpu = lambda: cpu_model.generate(*short, num_beams=beams,  # noqa: E731
                                                 max_length=8)[0].tolist()
            rec = []
            with avsr_recorded(rec):
                got = run_gpu()
            eos_ranked = sum(int((r[2][:, :beams] % cfg.vocab_size == cfg.eos_token_id).any())
                             for r in rec if r[0] == "top")
            same = same_avsr(f"avsr {label} beams={beams}: card vs CPU", got, run_cpu(),
                             run_gpu, run_cpu)
            log(f"avsr {label}, beams={beams}, max_length 8 on {name}: tokens {got} "
                f"{'equal to' if same else 'a near-tie from'} the CPU's"
                + (f"; EOS among the top {beams} in {eos_ranked} of 8 steps" if beams > 1
                   else ""))
    return short


def avsr_converted(model, short, name):
    """write_avhubert_hf_dir (tests/fixture_checkpoints.py: a config.json
    and pytorch_model.bin of the published naming) at the full width, then
    from_pretrained(dir) on the card: the tree's keys, shapes and dtypes
    against init's (less the training-only ctc_head, which the converter
    does not map), and greedy and beam-5 tokens on the short input equal to
    those of the same weights saved and loaded as a native tree."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from reazonspeech_tpu_torch.avsr import AVHubertForConditionalGeneration
    from reazonspeech_tpu_torch.convert import hf_avhubert
    from reazonspeech_tpu_torch.convert.store import save_param_tree

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import fixture_checkpoints as fx

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="avsr_hf_", dir=base)
    seconds = {}
    try:
        t0 = time.perf_counter()
        fx.write_avhubert_hf_dir(os.path.join(root, "hf"), model.config)
        seconds["fixture write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with swapped(hf_avhubert, "convert_avhubert_checkpoint",
                     timing(seconds, "conversion (read, map, save)")):
            conv = AVHubertForConditionalGeneration.from_pretrained(os.path.join(root, "hf"))
        seconds["from_pretrained"] = time.perf_counter() - t0
        check(conv.device == model.device, f"avsr converted: loaded on {conv.device}")
        check(conv.config == model.config, "avsr converted: the config differs from init's")
        same_tree_layout("avsr converted", conv.params,
                         {k: p for k, p in model.params.items() if k != "ctc_head"})
        tree = os.path.join(root, "tree")
        save_param_tree(tree, conv.params, {"flavor": "avhubert",
                                            "cfg": dataclasses.asdict(conv.config)})
        t0 = time.perf_counter()
        native = AVHubertForConditionalGeneration.from_pretrained(tree)
        seconds["native tree load"] = time.perf_counter() - t0
        for beams in (1, 5):
            got = conv.generate(*short, num_beams=beams, max_length=8)
            want = native.generate(*short, num_beams=beams, max_length=8)
            check(bool((got == want).all()),
                  f"avsr converted beams={beams}: tokens differ from the native tree's")
        log(f"avsr converted path on {name}: greedy and beam-5 tokens equal to the native "
            f"tree's; " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _wav_bytes(x):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def avsr_serving(model, name):
    """make_avsr_app (max_batch 16) on a ThreadingHTTPServer at 127.0.0.1:
    12 concurrent x-npz requests of 2-6 s (audio-visual, audio-only and
    video-only in turn) and one WAV request of 3 s (audio-only, features
    extracted by the server). Every answer must be 200 and equal the
    request's dedicated generate (alone, at its own length), or else differ
    at an fp32 near-tie under 1e-4 from the same request in the batch the
    server ran. Logs wall, audio-s/s, the batch shapes and p50/p95 latency."""
    import http.client
    import io
    import threading
    from http.server import ThreadingHTTPServer

    from reazonspeech_tpu_torch.avsr.feature_extraction import AVHubertFeatureExtractor
    from reazonspeech_tpu_torch.serving import http as port_http

    handler, batcher = port_http.make_avsr_app(model, max_batch=16)
    ticks = []  # the host batches the executor ran

    def keep(generate):
        def recording(audio, video, lens):
            ticks.append((audio, video, lens))
            return generate(audio, video, lens)
        return recording

    batcher._generate = keep(batcher._generate)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(152)
    reqs = []
    for i in range(12):
        mods = [(True, True), (True, False), (False, True)][i % 3]
        reqs.append(avsr_request(rng, float(rng.uniform(2.0, 6.0)), *mods))
    wav = speech_like(3.0, 153)
    wav_body = _wav_bytes(wav)
    feats = AVHubertFeatureExtractor()._extract_audio(
        port_http._decode_audio_body(wav_body, "audio/wav"))
    bodies = []
    for a, v in reqs:
        buf = io.BytesIO()
        np.savez(buf, **{k: x for k, x in (("audio", a), ("video", v)) if x is not None})
        bodies.append((buf.getvalue(), "application/x-npz"))
    bodies.append((wav_body, "audio/wav"))
    reqs.append((feats, None))

    def post(body, ctype):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/transcribe", body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data, time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        answers = concurrently([lambda b=b, c=c: post(b, c) for b, c in bodies])
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    bad = [(i, s, d[:200]) for i, (s, d, _) in enumerate(answers) if s != 200]
    check(not bad, f"avsr serving: answers other than 200: {bad}")
    audio_s = sum(len(a if a is not None else v) for a, v in reqs) / AVSR_FPS
    near = 0
    for i, ((a, v), (_, data, _)) in enumerate(zip(reqs, answers)):
        got = json.loads(data)["token_ids"]
        want, (audio, video, lens) = avsr_alone(model, a, v, 5)
        t = lens[0]
        # the tick that served the request, and its row there
        tick, row = next((tk, r) for tk in ticks for r in range(len(tk[2]))
                         if tk[2][r] == t and np.array_equal(tk[0][r, :t], audio[0])
                         and np.array_equal(tk[1][r, :t], video[0]))

        def served(tick=tick):
            model.generate(tick[0], tick[1], lengths=tick[2], num_beams=5,
                           max_length=AVSR_MAX_LENGTH)

        def dedicated(audio=audio, video=video, lens=lens):
            model.generate(audio, video, lengths=np.array(lens), num_beams=5,
                           max_length=AVSR_MAX_LENGTH)

        near += not same_avsr(f"avsr serving request {i}", got, want, served, dedicated,
                              row_a=row)
    lat = sorted(t for _, _, t in answers)
    log(f"avsr serving on {name}: {len(reqs)} requests ({audio_s:.1f} audio-s; 12 npz of 2-6 s, "
        f"1 WAV of 3 s) in {wall:.3f} s ({audio_s / wall:.2f} audio-s/s), {batcher.ticks} "
        f"ticks of batch shapes {sorted(batcher.batch_shapes)}, latency p50 {lat[len(lat) // 2]:.3f} s, p95 "
        f"{lat[min(len(lat) - 1, int(0.95 * len(lat)))]:.3f} s; {len(reqs) - near} answers "
        f"equal to their dedicated generate, {near} at an fp32 near-tie")


def avsr_phase(name):
    """Phase 11: the AVSR family at the published AV-HuBERT base width
    (AVHubertConfig(): 12 encoder layers of 768, 6 decoder layers, vocab
    8,000; random weights from seed 0) on the card: batch generate, the
    check against the CPU, the converted path and the HTTP front."""
    import gc

    import torch

    from reazonspeech_tpu_torch.avsr import AVHubertConfig, AVHubertForConditionalGeneration

    t_phase = time.perf_counter()
    cfg = AVHubertConfig()
    model = AVHubertForConditionalGeneration.init(torch.Generator().manual_seed(0), cfg)
    check(model.device.type == "cuda", f"avsr: init() loaded on {model.device}")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "avsr: TF32 is on after init()")
    log(f"avsr: AVHubertConfig() (encoder {cfg.num_hidden_layers} x {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}; decoder "
        f"{cfg.decoder_layers} x {cfg.decoder_hidden_size}, {cfg.decoder_attention_heads} heads; "
        f"vocab {cfg.vocab_size}) on {name}, init {time.perf_counter() - t_phase:.1f} s")
    avsr_batch_phase(model, name)
    short = avsr_cpu_check(model, name)
    avsr_converted(model, short, name)
    gc.collect()
    torch.cuda.empty_cache()
    avsr_serving(model, name)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"avsr phase: {time.perf_counter() - t_phase:.1f} s")


# --- the training path --------------------------------------------------------

# nemo's recipe (tools/tpu_train_bench.py's defaults): B = 4 x 15 s, U = 48
TRAIN_B, TRAIN_SECONDS, TRAIN_U = 4, 15.0, 48


def rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def train_configs(enc_cfg=None, rnnt_cfg=None):
    """The training configuration: FastConformerConfig.xlarge(remat=True) in
    the kernel configuration that autograd can take (attn and lnd "pallas",
    conv "xla", bf16 compute, fp32 residual) and RNNTConfig() at its width."""
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig

    if enc_cfg is None:
        enc_cfg = FastConformerConfig.xlarge(
            remat=True, attn_impl="pallas", lnd_impl="pallas", conv_impl="xla",
            compute_dtype="bfloat16", residual_dtype="float32")
    return enc_cfg, rnnt_cfg or RNNTConfig(enc_dim=enc_cfg.d_model)


def train_params(seed, enc_cfg, rnnt_cfg, dev):
    """init_params (from a seed, on ``dev``) with the simple joint of the
    pruned loss and a CTC head (blank 0, rnnt_cfg.num_classes tokens)."""
    import torch

    from reazonspeech_tpu_torch.models.conformer import init_ctc_head
    from reazonspeech_tpu_torch.nemo.asr.model import init_params
    from reazonspeech_tpu_torch.training import init_simple_joint

    params = init_params(seed, enc_cfg, rnnt_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params["simple_joint"] = init_simple_joint(gen, rnnt_cfg, device=dev)
    params["ctc"] = init_ctc_head(gen, enc_cfg.d_model, rnnt_cfg.num_classes, device=dev)
    return params


def train_batch(rnnt_cfg, seconds=TRAIN_SECONDS, b=TRAIN_B, u=TRAIN_U):
    """B utterances of speech_like audio and U labels from a numpy seed (in
    1 .. vocab-1: CTC's blank is 0); row 2 is shorter (11/15 of the
    seconds, 3/4 of the labels), so padding is exercised."""
    n = int(seconds * SR)
    wav = np.zeros((b, n), np.float32)
    lengths = np.full(b, n, np.int32)
    label_lengths = np.full(b, u, np.int32)
    lengths[2], label_lengths[2] = n * 11 // 15, u * 3 // 4
    for i in range(b):
        wav[i, :lengths[i]] = speech_like(lengths[i] / SR, seed=400 + i)
    labels = np.random.default_rng(401).integers(1, rnnt_cfg.vocab_size, (b, u)).astype(np.int32)
    for i in range(b):
        labels[i, label_lengths[i]:] = 0
    return {"waveform": wav, "lengths": lengths, "labels": labels,
            "label_lengths": label_lengths}


def train_wrapper_checks(enc_cfg, dev, t_fused):
    """Each of the six training wrappers at the training shapes: the kernel
    forward against the plain forward (relative L2 <= 2e-2), and the
    gradient of every differentiable input through the wrapper against the
    plain twin's autograd gradient (relative L2 <= 5e-2 at bf16). Rows 1 and
    8 take separate q/k/v at T=``t_fused``, row 8 also at T=549 (past the
    fused cap) and T=1100 (past the single-pass cap: the streamed kernel,
    row 9)."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops import relpos_attention as ra

    lnd = sys.modules["reazonspeech_tpu_torch.ops.ln_dense"]
    gen = torch.Generator(device=dev).manual_seed(500)
    bf16, f32 = torch.bfloat16, torch.float32
    d, h = enc_cfg.d_model, enc_cfg.num_heads
    dh, dff = d // h, d * enc_cfg.ff_expansion

    def rnd(*shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def lens(b, t):
        return torch.tensor([t, t - t // 5, t, t // 2][:b], dtype=torch.int32, device=dev)

    b, t = TRAIN_B, t_fused
    ln_g, ln_b = 1.0 + rnd(d, scale=0.1), rnd(d, scale=0.1)
    qkv_w = [rnd(d, d, dtype=bf16, scale=d ** -0.5) for _ in range(3)]
    qkv_c = [rnd(d, scale=0.1) for _ in range(3)]
    cases = [  # (wrapper's kernel, wrapper, twin, args, kwargs, label)
        ("ln_dense", lnd.ln_dense_diff, ops.ln_dense_plain,
         (rnd(b, t, d, scale=2.0), ln_g, ln_b, rnd(d, dff, dtype=bf16, scale=d ** -0.5),
          rnd(dff, scale=0.1)), dict(activation="swish"), f"FFN-in, T={t}"),
        ("ln_dense_add", lambda r, dl, g, bb, *wc: lnd.ln_dense_add_diff(
            r, dl, g, bb, wc[:3], wc[3:], scale=0.5),
         lambda r, dl, g, bb, *wc: ops.ln_dense_add_plain(r, dl, g, bb, wc[:3], wc[3:], 0.5),
         (rnd(b, t, d, scale=2.0), rnd(b, t, d, dtype=bf16), ln_g, ln_b, *qkv_w, *qkv_c), {},
         f"q/k/v, T={t}"),
        ("add_ln", lnd.add_ln_diff, ops.add_ln_plain,
         (rnd(b, t, d, scale=2.0), rnd(b, t, d, dtype=bf16), lens(b, t), ln_g, ln_b),
         dict(scale=0.5), f"T={t}"),
        ("relpos_attention_fused_packed", ra.relpos_attention_fused_packed_diff,
         ra.relpos_attention_fused_packed_plain,
         (rnd(b, t, 3 * d, dtype=bf16), rnd(2 * t - 1, h, dh, dtype=bf16), rnd(h, dh, scale=0.1),
          rnd(h, dh, scale=0.1), lens(b, t), h), {}, f"T={t}"),
        ("relpos_attention_fused", ra.relpos_attention_fused_diff, ra.relpos_attention_fused_plain,
         (rnd(b, t, d, dtype=bf16), rnd(b, t, d, dtype=bf16), rnd(b, t, d, dtype=bf16),
          rnd(2 * t - 1, h, dh, dtype=bf16), rnd(h, dh, scale=0.1), rnd(h, dh, scale=0.1),
          lens(b, t), h), {}, f"separate q/k/v, T={t}"),
    ]
    for bb, tt, kernel, plain in (
            (2, 549, "relpos_attention", ra.relpos_attention_plain),
            (1, 1100, "relpos_attention_blockwise", ra.relpos_attention_blockwise_plain)):
        cases.append((kernel, ra.relpos_attention_diff, plain,
                      tuple(rnd(bb, h, tt, dh, dtype=bf16) for _ in range(4))
                      + (rnd(2 * tt - 1, h, dh, dtype=bf16), lens(bb, tt)), {},
                      f"[B, H, T, dh], B={bb}, T={tt}"))
    rng = np.random.default_rng(501)
    for name, wrapper, plain, args, kw, label in cases:
        diff = [i for i, a in enumerate(args)
                if isinstance(a, torch.Tensor) and a.is_floating_point()]
        grads = {}
        outs = {}
        for which, fn in (("kernel", wrapper), ("plain", plain)):
            leaves = [a.detach().clone().requires_grad_(i in diff)
                      if isinstance(a, torch.Tensor) else a for i, a in enumerate(args)]
            ops.reset_launch_counts()
            out = fn(*leaves, **kw)
            out = out if isinstance(out, tuple) else (out,)
            if which == "kernel":
                check(ops.launch_counts()[name] > 0, f"{name} ({label}): the kernel did not launch")
                weights = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
                           .to(dev) for o in out]
            loss = sum((o.float() * w).sum() for o, w in zip(out, weights))
            grads[which] = torch.autograd.grad(loss, [leaves[i] for i in diff])
            outs[which] = out
        fwd = max(rel_l2(g, w) for g, w in zip(outs["kernel"], outs["plain"]))
        grad = max(rel_l2(g, w) for g, w in zip(grads["kernel"], grads["plain"]))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in grads["kernel"])
        what = f"the training wrapper over {name} ({label})"
        log(f"{what}: forward relative L2 {fwd:.3g} (tol 2e-2), gradients of {len(diff)} inputs, "
            f"largest relative L2 {grad:.3g} (tol 5e-2)")
        check(finite, f"{what}: non-finite gradients")
        check(fwd <= 2e-2, f"{what}: forward relative L2 {fwd}")
        check(grad <= 5e-2, f"{what}: gradient relative L2 {grad}")


def train_grads(params, batch, fe_cfg, enc_cfg, rnnt_cfg, dev, **loss_kw):
    """(loss, flat gradients, launches in the forward, launches in the
    backward) of compute_loss(loss="full", **loss_kw) on trainable copies
    of params."""
    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.training.train_step import compute_loss, tree_leaves, tree_map

    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    ops.reset_launch_counts()
    loss = compute_loss(p, tb, fe_cfg, enc_cfg, rnnt_cfg, **loss_kw)
    torch.cuda.synchronize()
    fwd = ops.launch_counts()
    ops.reset_launch_counts()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    bwd = ops.launch_counts()
    flat = torch.cat([(torch.zeros_like(x) if g is None else g).float().reshape(-1)
                      for x, g in zip(leaves, grads)])
    return loss.detach(), flat, fwd, bwd


def training_phase(name, dev="cuda", enc_cfg=None, rnnt_cfg=None, seconds=TRAIN_SECONDS,
                   t_fused=None):
    """The port's training at the full nemo width and depth (24 blocks,
    d=1024, remat), all on the card: the six wrappers at the training
    shapes against their twins; compute_loss(loss="full") with the kernels
    (rows 4-7 launched in the forward and again in remat's recompute)
    against the same with plain_twins() on the same params and batch (loss
    within 1e-2, gradients within relative L2 5e-2, all finite); Trainer.fit
    of 4 steps on one batch (the loss falls; ms a step, audio-s/s, peak
    memory); one step each of loss="pruned" and ctc_weight=0.3 (finite); a
    checkpoint at step 2 and a resume to step 4 at 2 blocks of the same
    width, against the uninterrupted run."""
    import gc
    import os
    import shutil
    import statistics
    import tempfile
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch.frontend.features import nemo_frontend_config
    from reazonspeech_tpu_torch.training import Trainer, TrainerConfig, make_train_step
    from reazonspeech_tpu_torch.training.train_step import tree_leaves

    full = enc_cfg is None
    enc_cfg, rnnt_cfg = train_configs(enc_cfg, rnnt_cfg)
    if full:
        check((enc_cfg.num_layers, enc_cfg.d_model, enc_cfg.num_heads, enc_cfg.conv_kernel,
               rnnt_cfg.vocab_size, rnnt_cfg.pred_hidden, rnnt_cfg.joint_hidden)
              == (24, 1024, 8, 9, 3000, 640, 640), "training: not the nemo xlarge width")
    fe_cfg = nemo_frontend_config()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    params = train_params(0, enc_cfg, rnnt_cfg, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    batch = train_batch(rnnt_cfg, seconds)
    audio_s = batch["lengths"].sum() / SR
    log(f"training: {enc_cfg.num_layers} blocks, d={enc_cfg.d_model}, remat={enc_cfg.remat}, "
        f"attn/lnd/conv={enc_cfg.attn_impl}/{enc_cfg.lnd_impl}/{enc_cfg.conv_impl}, "
        f"{enc_cfg.compute_dtype}/{enc_cfg.residual_dtype}; {n_params / 1e6:.1f}M params; "
        f"batch {TRAIN_B} x {seconds:.0f} s, U={TRAIN_U} (audio {batch['lengths'].tolist()} "
        f"samples, labels {batch['label_lengths'].tolist()}); init "
        f"{time.perf_counter() - t0:.1f} s")

    # the six wrappers at the training shapes (T of a 15 s row: 188 frames)
    t_fused = t_fused or int(seconds * 100) // 8 + 1
    train_wrapper_checks(enc_cfg, dev, t_fused)

    # the whole loss and its gradients, the kernels against their twins
    t0 = time.perf_counter()
    loss_k, g_k, fwd, bwd = train_grads(params, batch, fe_cfg, enc_cfg, rnnt_cfg, dev)
    t1 = time.perf_counter()
    with plain_twins():
        loss_p, g_p, fwd_p, _ = train_grads(params, batch, fe_cfg, enc_cfg, rnnt_cfg, dev)
    t2 = time.perf_counter()
    log(f"training step launches: forward {({k: fwd[k] for k in TRAIN_KERNELS})}, backward "
        f"(remat's recompute) {({k: bwd[k] for k in TRAIN_KERNELS})}; with the twins "
        f"{sum(fwd_p.values())} launches")
    check(all(fwd[k] > 0 for k in TRAIN_KERNELS), f"training forward: a kernel not launched {fwd}")
    check(all(bwd[k] > 0 for k in TRAIN_KERNELS) or not enc_cfg.remat,
          f"training backward: remat's recompute launched no kernel of rows 4-7: {bwd}")
    check(sum(fwd_p.values()) == 0, f"training with the twins launched kernels: {fwd_p}")
    dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    dg = rel_l2(g_k, g_p)
    log(f"training loss with the kernels {loss_k.item():.5f}, with the twins {loss_p.item():.5f}"
        f" (relative {dl:.3g}, tol 1e-2); gradients of {g_k.numel()} values, relative L2 "
        f"{dg:.3g} (tol 5e-2); loss+grad {t1 - t0:.2f} s with the kernels, {t2 - t1:.2f} s "
        f"with the twins (first calls)")
    check(bool(torch.isfinite(loss_k)) and bool(torch.isfinite(g_k).all()),
          "training: a non-finite loss or gradient")
    check(dl <= 1e-2, f"training loss: kernels vs twins relative {dl}")
    check(dg <= 5e-2, f"training gradients: kernels vs twins relative L2 {dg}")
    del g_k, g_p
    gc.collect()

    # Trainer.fit: 4 steps on one repeated batch
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainerConfig(warmup_steps=1, decay_steps=100, peak_lr=1e-4, log_every=1)
    trainer = Trainer(fe_cfg, enc_cfg, rnnt_cfg, cfg, device=dev).init(params)
    walls = []

    def timed(batches):
        for b in batches:
            torch.cuda.synchronize()
            walls.append(time.perf_counter())
            yield b

    hist = trainer.fit(timed([batch] * 5), max_steps=4)
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    steps_s = np.diff(walls)[:4]
    losses = [r["loss"] for r in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else float("nan")
    step_ms = statistics.median(steps_s[1:]) * 1e3
    log(f"training Trainer.fit on {name}: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 3) for r in hist]}; ms a step "
        f"{[round(float(s) * 1e3, 1) for s in steps_s]}"
        f" (median of steps 2-4 {step_ms:.1f} ms: {audio_s / step_ms * 1e3:.2f} training "
        f"audio-s/s over {audio_s:.0f} s of audio); torch.cuda.max_memory_allocated "
        f"{peak:.2f} GiB")
    check(len(losses) == 4 and all(np.isfinite(losses)), f"training: losses {losses}")
    check(losses[-1] < losses[0], f"training: the loss did not fall over 4 steps: {losses}")
    del trainer
    gc.collect()

    # one step each of the other objectives
    for kw in (dict(loss="pruned", s_range=5), dict(ctc_weight=0.3)):
        init_state, step = make_train_step(fe_cfg, enc_cfg, rnnt_cfg, **kw)
        t0 = time.perf_counter()
        state, m = step(init_state(params), batch)
        torch.cuda.synchronize()
        log(f"training step {kw}: loss {m['loss'].item():.4f}, grad norm "
            f"{m['grad_norm'].item():.3f}, {time.perf_counter() - t0:.2f} s (a first call)")
        check(bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
              and all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.params)),
              f"training {kw}: non-finite")
        del state
        gc.collect()
    del params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    # checkpoint at step 2 and resume to 4, at 2 blocks of the same width
    small = replace(enc_cfg, num_layers=min(2, enc_cfg.num_layers))
    small_params = train_params(1, small, rnnt_cfg, dev)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=base)
    try:
        cfg = TrainerConfig(checkpoint_dir=root, save_every=2, warmup_steps=1, decay_steps=100,
                            peak_lr=1e-4, log_every=1)
        straight = Trainer(fe_cfg, small, rnnt_cfg, replace(cfg, checkpoint_dir=None),
                           device=dev).init(small_params)
        h_straight = straight.fit([batch] * 4, max_steps=4)
        first = Trainer(fe_cfg, small, rnnt_cfg, cfg, device=dev).init(small_params)
        first.fit([batch] * 2, max_steps=2)
        t0 = time.perf_counter()
        first.save()
        saved = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        resumed = Trainer(fe_cfg, small, rnnt_cfg, cfg, device=dev).restore_latest(small_params)
        restored = time.perf_counter() - t0
        check(resumed.state.step == 2, f"training resume: step {resumed.state.step}")
        h_resumed = resumed.fit([batch] * 2, max_steps=4)
        a = torch.cat([x.detach().float().reshape(-1) for x in tree_leaves(straight.state.params)])
        c = torch.cat([x.detach().float().reshape(-1) for x in tree_leaves(resumed.state.params)])
        p0 = torch.cat([x.float().reshape(-1) for x in tree_leaves(small_params)])
        moved = rel_l2(c - p0, a - p0)
        l_a = [r["loss"] for r in h_straight][2:]
        l_c = [r["loss"] for r in h_resumed][-2:]
        log(f"training resume at {small.num_layers} blocks of d={small.d_model}: checkpoint "
            f"{size / 2 ** 20:.0f} MiB written in {saved:.2f} s, restored in {restored:.2f} s; "
            f"losses at steps 3-4 {l_c} resumed, {l_a} uninterrupted; params at step 4: the "
            f"resumed update against the uninterrupted one, relative L2 {moved:.3g} (tol 1e-2), "
            f"equal bit for bit: {torch.equal(a, c)}")
        check(resumed.state.step == 4 and straight.state.step == 4, "training resume: steps")
        check(all(abs(x - y) <= 1e-2 * abs(y) for x, y in zip(l_c, l_a)),
              f"training resume: losses {l_c} against {l_a}")
        check(moved <= 1e-2, f"training resume: params differ by {moved} relative")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")


# --- the streaming encoder and the host-side modules ---------------------------

STREAM_SECONDS, STREAM_B = 30.0, 4  # 4 x 30 s: 3,001 mel frames, 23 chunks of 128
STREAM_TOL = 5e-2  # kernels vs twins over 24 blocks and 23 chunks of bf16 caches
CHUNK_MS = 1280.0  # the audio one 16-frame chunk carries


def _step_times(fs, params, feats, cfg, scfg, steps=8):
    """Host ms to issue a streaming step, CUDA-event ms between its start
    and end on the stream, and its latency (host, to the output on the
    device, synchronised): medians over ``steps`` steps after two warm-up
    steps, stepping through ``feats``."""
    import statistics

    import torch

    mpc = 8 * scfg.chunk_frames
    state = fs.streaming_init_state(cfg, scfg, feats.shape[0], device=feats.device)
    host, dev_ms, latency = [], [], []
    for i in range(steps + 2):
        chunk = feats[:, i * mpc:(i + 1) * mpc]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, state = fs.streaming_step(params, state, chunk, cfg, scfg)
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 2:
            host.append((t1 - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
            latency.append((t2 - t0) * 1e3)
    return tuple(statistics.median(v) for v in (host, dev_ms, latency)), state


def streaming_phase(name):
    """The port's cache-based streaming FastConformer at the full nemo width
    (load_model(device="cuda", checkpoint="random"): 24 blocks, d=1024, the
    serving configuration, so each FFN-in is row 4), StreamingConfig()
    (16-frame chunks of 1.28 s, left context 64, sub-context 16):
    streaming_encode of the frontend features of 4 x 30 s (23 chunks, 368
    encoder frames), timed through the port's RTFxMeter, with row 4
    launched exactly 2 x 24 x 23 times and no other kernel; the stepped loop
    bit-equal to it; causality at B=1 (the last chunk's features changed:
    every earlier output bit-equal); the whole encode with the kernels
    against their plain twins (no launch) within relative L2 5e-2; at fp32
    and 2 blocks of the full width, 4 chunks against the port on the CPU
    within relative L2 1e-4; host ms, CUDA-event ms, device busy ms,
    launches and latency a step at B=1 and B=4; one step under
    utils.profiling.trace, whose Chrome trace must name row 4's kernel.
    Returns (row 4's launches, the model)."""
    import os
    import shutil
    import tempfile
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram
    from reazonspeech_tpu_torch.models import fastconformer_streaming as fs
    from reazonspeech_tpu_torch.models.fastconformer import _layer
    from reazonspeech_tpu_torch.nemo.asr import load_model
    from reazonspeech_tpu_torch.training.train_step import tree_map
    from reazonspeech_tpu_torch.utils import RTFxMeter, trace

    t0 = time.perf_counter()
    model = load_model(device="cuda", checkpoint="random")
    cfg, scfg, params = model.enc_cfg, fs.StreamingConfig(), model.params["encoder"]
    check((cfg.d_model, cfg.num_layers, cfg.num_heads) == (1024, 24, 8), "not the xlarge width")
    check((cfg.attn_impl, cfg.conv_impl, cfg.lnd_impl) == ("pallas",) * 3,
          "load_model on CUDA is not the serving configuration")
    check((scfg.chunk_frames, scfg.left_context, scfg.sub_context) == (16, 64, 16),
          f"StreamingConfig() is {scfg}")
    dev = model.device
    wav = np.stack([speech_like(STREAM_SECONDS, seed=40 + i) for i in range(STREAM_B)])
    with torch.inference_mode():
        lens = torch.full((STREAM_B,), wav.shape[1], dtype=torch.int32, device=dev)
        feats, _ = log_mel_spectrogram(torch.from_numpy(wav).to(dev), lens, model.fe_cfg)
    mpc = 8 * scfg.chunk_frames
    n_chunks = feats.shape[1] // mpc
    check(n_chunks == 23, f"streaming: {n_chunks} chunks of 4 x 30 s, expected 23")
    fs.streaming_encode(params, feats[:, :2 * mpc], cfg, scfg)  # warm-up: handles, allocator
    torch.cuda.synchronize()
    log(f"streaming: load_model and features {time.perf_counter() - t0:.1f} s; {cfg.num_layers} "
        f"blocks, d={cfg.d_model}, lnd={cfg.lnd_impl}, {cfg.compute_dtype}; {scfg}; features "
        f"{tuple(feats.shape)}, {n_chunks} chunks")

    # the counted run
    meter = RTFxMeter()
    ops.reset_launch_counts()
    with meter.measure(audio_seconds=STREAM_B * STREAM_SECONDS):
        enc = fs.streaming_encode(params, feats, cfg, scfg)
        torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = 2 * cfg.num_layers * n_chunks
    log(f"streaming_encode 4 x 30 s on {name}: {meter.summary()} ({meter.rtfx:.2f} audio-s/s); "
        f"launch counts {counts} (row 4: {want} expected)")
    check(counts == {"ln_dense": want}, f"streaming: launches {counts}, expected ln_dense {want}")
    check(tuple(enc.shape) == (STREAM_B, 16 * n_chunks, cfg.d_model) and enc.dtype == torch.float32,
          f"streaming: output {tuple(enc.shape)} {enc.dtype}")
    check(bool(torch.isfinite(enc).all()), "streaming: non-finite output")

    # stepping by hand is the same program
    state = fs.streaming_init_state(cfg, scfg, STREAM_B, device=dev)
    outs = []
    for i in range(n_chunks):
        out, state = fs.streaming_step(params, state, feats[:, i * mpc:(i + 1) * mpc], cfg, scfg)
        outs.append(out)
    check(torch.equal(torch.cat(outs, dim=1), enc), "streaming: stepped != streaming_encode")
    check(state["frames_seen"].tolist() == [16 * n_chunks] * STREAM_B, "streaming: frames_seen")
    log("streaming: the stepped loop == streaming_encode, bit for bit")

    # causality at B=1: the last of 6 chunks changed
    f1 = feats[:1, :6 * mpc]
    f2 = f1.clone()
    f2[:, -mpc:] += 5.0
    o1, o2 = (fs.streaming_encode(params, f, cfg, scfg) for f in (f1, f2))
    check(torch.equal(o1[:, :-16], o2[:, :-16]), "streaming: a future chunk changed a past output")
    check(not torch.equal(o1[:, -16:], o2[:, -16:]),
          "streaming: the changed chunk's output did not change")
    log("streaming causality at B=1: the first 5 chunks' outputs bit-equal, the 6th changed")

    # the whole encode on the plain twins
    ops.reset_launch_counts()
    with plain_twins():
        ref = fs.streaming_encode(params, feats, cfg, scfg)
    torch.cuda.synchronize()
    check(sum(ops.launch_counts().values()) == 0, "streaming with the twins launched a kernel")
    rel = rel_l2(enc, ref)
    log(f"streaming 4 x 30 s, kernels vs plain twins: relative L2 {rel:.3g} (tol {STREAM_TOL}), "
        f"max abs {(enc - ref).abs().max().item():.3g}")
    check(rel <= STREAM_TOL, f"streaming: kernels vs twins relative L2 {rel}")

    # fp32 at 2 blocks of the full width: the card against the CPU
    small = replace(cfg, num_layers=2, compute_dtype="float32", attn_impl="xla", conv_impl="xla",
                    lnd_impl="xla")
    sp = {"subsampling": params["subsampling"], "blocks": _layer(params["blocks"], slice(0, 2))}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = fs.streaming_encode(sp, feats[:2, :4 * mpc], small, scfg)
    want_cpu = fs.streaming_encode(tree_map(torch.Tensor.cpu, sp), feats[:2, :4 * mpc].cpu(),
                                   small, scfg)
    rel = rel_l2(got.cpu(), want_cpu)
    log(f"streaming fp32, 2 blocks of d={cfg.d_model}, 2 x 4 chunks: the card vs the port on the "
        f"CPU, relative L2 {rel:.3g} (tol 1e-4)")
    check(rel <= 1e-4, f"streaming fp32: card vs CPU relative L2 {rel}")

    # a step at B=1 and B=4: host, events, device busy, launches, latency
    for b in (1, STREAM_B):
        (host, ev, lat), state = _step_times(fs, params, feats[:b], cfg, scfg)
        chunk = feats[:b, 10 * mpc:11 * mpc]
        items = device_items(lambda: fs.streaming_step(params, state, chunk, cfg, scfg), 4)
        busy = sum(ms for _, ms, _ in items) if items else None
        n_dev = sum(c for _, _, c in items) if items else None
        top = ", ".join(f"{k[:40]} {ms:.3f} ms x{c:.0f}"
                        for k, ms, c in sorted(items, key=lambda x: -x[1])[:5])
        log(f"streaming step B={b} on {name}: host {host:.2f} ms to issue, CUDA events "
            f"{ev:.2f} ms, device busy {fmt_ms(busy)} ms, "
            f"{'not measured' if n_dev is None else f'{n_dev:.0f}'} device launches, latency "
            f"{lat:.2f} ms against the {CHUNK_MS:.0f} ms chunk it consumes "
            f"({lat / CHUNK_MS * 100:.2f} %); largest items: {top}")
        check(lat < CHUNK_MS, f"streaming step B={b}: {lat} ms is slower than real time")

    # one step under utils.profiling.trace
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="stream_trace_", dir=base)
    try:
        with trace(root) as path:
            fs.streaming_step(params, state, feats[:STREAM_B, :mpc], cfg, scfg)
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        named = sorted(k for k in kernels if "dense_kernel" in k or "ln_rows" in k)
        log(f"streaming trace {os.path.basename(path)}: {os.path.getsize(path) / 2 ** 20:.1f} MiB, "
            f"{len(kernels)} kernel names; row 4's: {named}")
        check(any("dense_kernel" in k for k in named), "streaming trace: no row-4 kernel named")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return want, model


class _TranscribeEvaluator:
    """Mixin of the smoke's evaluator: the port's nemo transcribe_batch over
    the rows' WAV paths. ``datasets`` hashes the mapped method with its
    instance, so the pickled state leaves the model out."""

    def _evaluate(self, example, **kwargs):
        from reazonspeech_tpu_torch.nemo.asr import audio_from_path, transcribe

        return {"prediction": transcribe(self.model, audio_from_path(example["audio"])).text}

    def _evaluate_batch(self, batch, **kwargs):
        from reazonspeech_tpu_torch.nemo.asr import audio_from_path, transcribe_batch

        audios = [audio_from_path(p) for p in batch["audio"]]
        return {"predictions": [r.text for r in transcribe_batch(self.model, audios)]}

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "model"}


def host_modules_phase(name, model):
    """The host-side modules on the card's machine: native/ built by g++
    there (edit_distance against the pure-Python one on 200 seeded pairs,
    wav_batch_load of 8 WAVs written by audio_to_file against the Python
    decode); resample on the card (4 x 30 s at 48 and 44.1 kHz) against
    scipy's resample_poly in float64 on the host within 5e-4, its device ms
    and peak memory; the evaluation harness (datasets and multiprocess
    import on that machine) over the nemo model: evaluate(dataset=<a local
    jsonl of 8 WAVs>, batch_size=4), each prediction equal to
    transcribe_batch on the same 4 rows, the printed CER equal to
    Σdistance/Σlength; the compile cache: the built kernel library copied
    into a directory that a subprocess with REAZONSPEECH_TPU_COMPILE_CACHE
    set there loads without nvcc, and reazonspeech-serve --compile-cache DIR
    parsed."""
    import io
    import os
    import shutil
    import tempfile
    from math import gcd

    import torch
    from scipy.signal import resample_poly

    from reazonspeech_tpu_torch import native
    from reazonspeech_tpu_torch.core import text
    from reazonspeech_tpu_torch.core.audio import audio_from_numpy, audio_from_path, audio_to_file
    from reazonspeech_tpu_torch.frontend import resample
    from reazonspeech_tpu_torch.nemo.asr import transcribe_batch
    from reazonspeech_tpu_torch.ops import _kernels
    from reazonspeech_tpu_torch.serving import http as port_http

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    root = tempfile.mkdtemp(prefix="host_modules_", dir=base)
    try:
        # native/: built here by g++
        t0 = time.perf_counter()
        check(native.available(), "native: no C++ compiler on the card's machine")
        info = native.build_info()
        log(f"native: {info['path']} ({info['log'][:40]!r}) in {time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(0)
        alphabet = list("あいうえおかきくけこさしすせそabc、。 ")
        for _ in range(200):
            a, b = ("".join(rng.choice(alphabet, rng.integers(0, 60))) for _ in range(2))
            check(native.edit_distance(a, b) == text._edit_distance_python(a, b),
                  f"native edit_distance({a!r}, {b!r})")
        wavs = []
        for i in range(8):
            x = speech_like(float(rng.uniform(2.0, 6.0)), seed=60 + i)
            wavs.append(os.path.join(root, f"u{i}.wav"))
            audio_to_file(wavs[-1], audio_from_numpy(x, SR))
        stride = max(native.wav_info(p)[1] for p in wavs)
        batch, lengths = native.wav_batch_load(wavs, stride)
        for i, p in enumerate(wavs):
            want = np.asarray(audio_from_path(p).waveform, np.float32)
            check(lengths[i] == len(want) and np.array_equal(batch[i, :lengths[i]], want),
                  f"native wav_batch_load row {i} differs from the Python decode")
        log("native: edit_distance == the Python one on 200 pairs; wav_batch_load of 8 WAVs == "
            "the Python decode")

        # resample on the card
        for sr in (48000, 44100):
            host = np.stack([speech_like(30.0 * sr / SR, seed=70 + i)[: 30 * sr]
                             for i in range(4)])
            x = torch.from_numpy(host).to(model.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            got = resample(x, sr, SR)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
            g = gcd(sr, SR)
            want = resample_poly(host.astype(np.float64), SR // g, sr // g, axis=1)
            err = float(np.abs(got.cpu().numpy() - want).max())
            ms = cuda_ms(lambda: resample(x, sr, SR), 10)
            log(f"resample 4 x 30 s {sr} -> {SR} Hz on {name}: {tuple(got.shape)}, max abs err "
                f"vs scipy float64 {err:.3g} (tol 5e-4); events ms {ms:.3f}, device ms "
                f"{fmt_ms(device_ms(lambda: resample(x, sr, SR), 5))}; peak memory above the "
                f"input {peak:.1f} MiB (input {host.nbytes / 2 ** 20:.1f} MiB)")
            check(got.shape == want.shape and err <= 5e-4, f"resample {sr}: err {err}")

        # evaluation: BaseEvaluator over the port's nemo model, a local jsonl
        os.environ.update(HF_DATASETS_CACHE=os.path.join(root, "datasets"),
                          HF_HOME=os.path.join(root, "hf"), HF_HUB_OFFLINE="1",
                          HF_DATASETS_OFFLINE="1")
        from reazonspeech_tpu_torch.evaluation import BaseEvaluator

        class Evaluator(_TranscribeEvaluator, BaseEvaluator):
            pass

        truths = ["こんにちは", "ありがとうございます", "さようなら", "おはよう",
                  "今日は晴れです", "音声認識", "東京", "一二三"]
        manifest = os.path.join(root, "eval.jsonl")
        with open(manifest, "w", encoding="utf-8") as f:
            for p, t in zip(wavs, truths):
                f.write(json.dumps({"audio": p, "text": t}, ensure_ascii=False) + "\n")
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            evaluated = Evaluator(model=model).evaluate(dataset=manifest, batch_size=4)
        wall = time.perf_counter() - t0
        preds = list(evaluated["prediction"])
        direct = [r.text for i in (0, 4)
                  for r in transcribe_batch(model, [audio_from_path(p) for p in wavs[i:i + 4]])]
        check(preds == direct, "evaluation: predictions differ from transcribe_batch's")
        dist, length = list(evaluated["distance"]), list(evaluated["length"])
        cer_line = [x for x in out.getvalue().splitlines() if x.startswith("CER:")]
        check(cer_line == [f"CER: {sum(dist) / sum(length) * 100:.2f}%"],
              f"evaluation: printed {cer_line}, Σdistance/Σlength {sum(dist)}/{sum(length)}")
        log(f"evaluation: evaluate(jsonl of 8 WAVs, batch_size=4) in {wall:.2f} s: predictions "
            f"== transcribe_batch's ({[len(p) for p in preds]} characters), {cer_line[0]} == "
            f"{sum(dist)}/{sum(length)}")

        # the compile cache: the built library loaded from a cache directory
        cache = os.path.join(root, "cache")
        so = _kernels.build_info()["path"]
        os.makedirs(os.path.join(cache, "torch_kernels"))
        shutil.copy(so, os.path.join(cache, "torch_kernels", os.path.basename(so)))
        code = ("import json; from reazonspeech_tpu_torch.utils import enable_compile_cache; "
                "from reazonspeech_tpu_torch.ops import _kernels; d = enable_compile_cache(); "
                "_kernels.load_library(); print(json.dumps([d, _kernels.build_info()]))")
        env = dict(os.environ, REAZONSPEECH_TPU_COMPILE_CACHE=cache,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=300)
        check(proc.returncode == 0, f"compile cache subprocess failed: {proc.stderr[-2000:]}")
        d, info = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"compile cache: a process with REAZONSPEECH_TPU_COMPILE_CACHE={cache} loaded "
            f"{info['path']} ({info['log']!r}) in {time.perf_counter() - t0:.1f} s")
        check(d == cache and info["log"] == "(cached)" and info["path"].startswith(cache),
              f"compile cache: {d}, {info}")

        saved = (_kernels.BUILD_DIR, native.BUILD_DIR)
        served = io.StringIO()

        def refuse(*args, **kwargs):
            raise SystemExit(0)
        try:
            with swapped(port_http, "_load_flavor", lambda fn: refuse):
                with contextlib.redirect_stdout(served):
                    try:
                        port_http.main(["--checkpoint", "random", "--compile-cache", cache])
                    except SystemExit:
                        pass
        finally:
            _kernels.BUILD_DIR, native.BUILD_DIR = saved
        check(f"compile cache: {cache}" in served.getvalue(),
              f"reazonspeech-serve --compile-cache: {served.getvalue()!r}")
        log("reazonspeech-serve --compile-cache DIR: parsed, the cache enabled before the load")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- parallelism over a single-process mesh -------------------------------------

PARALLEL_DP_SECONDS, PARALLEL_PP_SECONDS = 10.0, 30.0
PP_STAGES, PP_MICRO = 2, 4
PIPE_TOL = 5e-2  # relative L2: bf16 kernels and cuBLAS products at 1 row a microbatch vs 4


def mesh_entries(n, dev="cuda"):
    """``n`` mesh entries over the visible cards, ``cuda:(i % cards)``
    (``dev="cpu"``: n CPU entries, for a rehearsal)."""
    import torch

    if torch.device(dev).type == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def entry_peaks(devices):
    """{device: peak GiB allocated since the last reset} of each distinct card."""
    import torch

    return {str(d): round(torch.cuda.max_memory_allocated(d) / 2 ** 30, 2)
            for d in dict.fromkeys(devices)}


def reset_peaks(devices):
    import torch

    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def parallel_tp_checks(dev, b, t):
    """Rows 4, 5 and 7 at the shapes the dp x tp step gives them on a model
    entry of a 2 x 2 mesh (B = b rows of a data shard, T = t): row 4 on its
    column shard of the FFN-in (N = 2,048 of 4,096), row 5 with the packed
    q|k|v of 4 of the 8 heads (three [1024, 512] segments), row 7 on 4 heads."""
    import torch

    from reazonspeech_tpu_torch import ops

    gen = torch.Generator().manual_seed(700)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=dtype)

    d, h, n = 1024, 4, 2
    lengths = torch.tensor([t, t * 11 // 15][:b], dtype=torch.int32, device=dev)
    x = rand(b, t, d, dtype=f32) + 0.5
    g, beta = 1.0 + rand(d, scale=0.1, dtype=f32), rand(d, scale=0.1, dtype=f32)
    rows = [_compare("ln_dense_tp", ops.ln_dense, ops.ln_dense_plain,
                     (x, g, beta, rand(d, 4 * d // n, scale=0.5 * d ** -0.5),
                      rand(4 * d // n, scale=0.1, dtype=f32)), "bf16", iters=20,
                     kwargs=dict(activation="swish"), label=f"FFN-in column shard, N={4 * d // n}",
                     flops=flops_ln_dense)]
    w_qkv = tuple(rand(d, d // n, scale=0.5 * d ** -0.5) for _ in range(3))
    c_qkv = tuple(rand(d // n, scale=0.1, dtype=f32) for _ in range(3))
    rows.append(_compare("ln_dense_add_tp", ops.ln_dense_add, ops.ln_dense_add_plain,
                         (x, rand(b, t, d), g, beta, w_qkv, c_qkv), ("bf16", 1e-5), iters=20,
                         kwargs=dict(scale=0.5), label=f"q|k|v of {h} heads",
                         flops=lambda a, o: flops_ln_dense(a, o, w_at=4)))
    qkv = rand(b, t, 3 * d // n, scale=0.5)
    pos = rand(2 * t - 1, h, d // 8, scale=0.5)
    bu, bv = rand(h, d // 8, scale=0.1, dtype=f32), rand(h, d // 8, scale=0.1, dtype=f32)
    rows.append(_compare("relpos_attention_fused_packed_tp", ops.relpos_attention_fused_packed,
                         ops.relpos_attention_fused_packed_plain, (qkv, pos, bu, bv, lengths, h),
                         0.03, iters=20, label=f"{h} heads", flops=flops_relpos))
    heads_first = lambda y: y.reshape(b, t, h, d // 8).transpose(1, 2)  # noqa: E731
    q = heads_first(qkv[..., :d // n])
    sdpa_yardstick(rows[-1], f"{h} heads", q + bu.to(bf16)[:, None], q + bv.to(bf16)[:, None],
                   heads_first(qkv[..., d // n:2 * d // n]), heads_first(qkv[..., 2 * d // n:]),
                   pos, lengths)
    return rows


def parallel_phase(name, dev="cuda"):
    """Parallelism over a single-process mesh whose entries name the card
    (``cuda:(i % cards)``; on one card every entry is ``cuda:0``, so these
    runs check correctness and placement, not scaling), with nemo at the
    full xlarge width and depth: DataParallelDecoder over 2 entries on
    4 x 10 s, each shard's rows bit-equal to a single-device decode_batch of
    them; ContinuousBatcher(mesh=2 entries) on 4 x 3 s against a
    MicroBatcher; pipeline_parallel_encode at S=2, M=4 on 4 x 30 s against
    fastconformer_encode (row 4 launched 2 x 24 x M times); one pipeline
    train step's loss and gradients against the single-device step's; one
    Trainer(mesh=2x2) step's loss against the single-device Trainer's;
    sequence_parallel_encode over 2 entries in fp32 against the unsplit
    plain encode; rows 4, 5 and 7 at the tensor-parallel shapes against
    their twins. Returns (the tensor-parallel rows, their launches in the
    dp x tp step)."""
    import gc
    from dataclasses import replace

    import torch

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram, nemo_frontend_config
    from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode
    from reazonspeech_tpu_torch.nemo.asr import load_model as nemo_load
    from reazonspeech_tpu_torch.parallel import (
        DataParallelDecoder, PipelineSpec, make_mesh, make_pipeline_mesh,
        pipeline_parallel_encode, sequence_parallel_encode,
    )
    from reazonspeech_tpu_torch.parallel.pipeline import shard_params_pipeline
    from reazonspeech_tpu_torch.serving import ContinuousBatcher, MicroBatcher
    from reazonspeech_tpu_torch.training import Trainer, TrainerConfig

    steps = {}
    t_phase = time.perf_counter()
    two, four = mesh_entries(2, dev), mesh_entries(4, dev)
    cards = torch.cuda.device_count()
    log(f"parallel on {name}: {cards} card(s); 2 entries {[str(d) for d in two]}, 4 entries "
        f"{[str(d) for d in four]}" + ("; every entry shares one card: these runs check "
                                       "correctness and placement, not scaling"
                                       if len(set(four)) < 4 else ""))
    model = nemo_load(device=dev, checkpoint="random")
    cfg = model.enc_cfg
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.lnd_impl, cfg.attn_impl,
           cfg.conv_impl) == (24, 1024, 8, "pallas", "pallas", "pallas"),
          "parallel: nemo is not the xlarge serving configuration")

    # 1. data-parallel decode: 4 x 10 s over 2 entries
    t0 = time.perf_counter()
    n = int(PARALLEL_DP_SECONDS * SR)
    padded = -(-n // model.bucket_samples) * model.bucket_samples
    buf = np.zeros((4, padded), np.float32)
    lens = np.full(4, n, np.int32)
    for i in range(4):
        buf[i, :n] = speech_like(PARALLEL_DP_SECONDS, seed=600 + i)
    # one device first: the 4-row call, then each shard's 2 rows (the batch
    # shapes the shards run, so the mesh's first call meets no new shape)
    t1 = time.perf_counter()
    model.decode_batch(buf, lens)
    single_wall = time.perf_counter() - t1
    wants, shard_walls = [], []
    for d in range(2):
        t1 = time.perf_counter()
        wants.append(model.decode_batch(buf[2 * d:2 * d + 2], lens[2 * d:2 * d + 2]))
        shard_walls.append(time.perf_counter() - t1)
    dp = DataParallelDecoder(model, make_mesh(2, devices=two))
    try:
        reset_peaks(two)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        got = dp.decode_batch(buf, lens)
        torch.cuda.synchronize()
        dp_first = time.perf_counter() - t1
        dp_counts = ops.launch_counts()
        dp_peak = entry_peaks(two)
        t1 = time.perf_counter()
        dp.decode_batch(buf, lens)
        dp_wall = time.perf_counter() - t1
    finally:
        dp.close()
    for d, want in enumerate(wants):
        for i, (g, w) in enumerate(zip(got, want)):
            check(np.array_equal(g[2 * d:2 * d + 2], w),
                  f"parallel: shard {d}'s output {i} differs from a single-device decode_batch "
                  "of its rows")
    check(all(dp_counts[k] > 0 for k in SERVING_KERNELS),
          f"parallel: the data-parallel decode did not launch every serving kernel {dp_counts}")
    audio_s = 4 * PARALLEL_DP_SECONDS
    log(f"parallel DataParallelDecoder 2 entries, 4 x {PARALLEL_DP_SECONDS:.0f} s on {name}: "
        f"{dp_wall:.3f} s wall ({audio_s / dp_wall:.2f} audio-s/s; the first call on the "
        f"entries' fresh threads and streams, at shapes already run, {dp_first:.3f} s) against "
        f"one device's 4-row decode_batch "
        f"{single_wall:.3f} s ({audio_s / single_wall:.2f} audio-s/s) and its 2-row decodes "
        f"of each shard's rows {[round(w, 3) for w in shard_walls]} s; emissions "
        f"{got[2].tolist()}; each shard's "
        f"rows == a single-device decode_batch of them, bit for bit; launches "
        f"{ {k: dp_counts[k] for k in SERVING_KERNELS} }; peak GiB {dp_peak}")
    steps["data-parallel decode"] = time.perf_counter() - t0

    # 2. the continuous executor's lane pool over 2 entries: 4 x 3 s
    t0 = time.perf_counter()
    pool_kw = dict(n_lanes=4, frames_per_segment=32, max_seconds=4.0, max_encode_batch=4,
                   mesh=make_mesh(2, devices=two))
    wavs = [speech_like(3.0, seed=620 + i) for i in range(4)]
    pool = ContinuousBatcher(model, **pool_kw)
    try:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        answers = [f.result(timeout=600) for f in [pool.submit(w) for w in wavs]]
        pool_wall = time.perf_counter() - t1
        pool_counts = ops.launch_counts()
        groups = [(str(g.device), g.lo, g.hi) for g in pool._groups]
    finally:
        pool.close()
    micro = MicroBatcher(model, fixed_shape=(pool.max_encode_batch, pool.max_samples))
    try:
        static = [f.result(timeout=600) for f in [micro.submit(w) for w in wavs]]
    finally:
        micro.close()
    near = 0
    for i, (w, a, st) in enumerate(zip(wavs, answers, static)):
        if tuple(a) != tuple(st):
            lone = serving_near_tie(f"parallel ContinuousBatcher request {i}", "alsd", model,
                                    pool_kw, w, st)
            check(tuple(lone) == tuple(a), f"parallel: request {i} decodes otherwise alone")
            near += 1
    check(all(pool_counts[k] > 0 for k in SERVING_KERNELS),
          f"parallel: the mesh pool did not launch every serving kernel {pool_counts}")
    log(f"parallel ContinuousBatcher(mesh=2 entries) on {name}: lane groups {groups}; 4 x 3 s "
        f"in {pool_wall:.3f} s; answers == the MicroBatcher's: {4 - near} of 4 (the rest fp32 "
        f"near-ties)")
    steps["continuous over the mesh"] = time.perf_counter() - t0

    # 3. the GPipe encoder: S=2, M=4 on 4 x 30 s
    t0 = time.perf_counter()
    n = int(PARALLEL_PP_SECONDS * SR)
    wav = torch.from_numpy(np.stack([speech_like(PARALLEL_PP_SECONDS, seed=640 + i)
                                     for i in range(4)])).to(dev)
    with torch.inference_mode():
        feats, flens = log_mel_spectrogram(wav, torch.full((4,), n, device=dev), model.fe_cfg)
        pmesh = make_pipeline_mesh(PP_STAGES, devices=two)
        staged = shard_params_pipeline(model.params["encoder"], pmesh)
        ref, _ = fastconformer_encode(model.params["encoder"], feats, flens, cfg)
        reset_peaks(two)
        ops.reset_launch_counts()
        piped, _ = pipeline_parallel_encode(staged, feats, flens, cfg, pmesh, n_micro=PP_MICRO)
        torch.cuda.synchronize()
        pp_counts = ops.launch_counts()
        pp_peak = entry_peaks(two)
        pp_ms = cuda_ms(lambda: pipeline_parallel_encode(staged, feats, flens, cfg, pmesh,
                                                         n_micro=PP_MICRO), 3, warmup=1)
        enc_ms = cuda_ms(lambda: fastconformer_encode(model.params["encoder"], feats, flens, cfg),
                         3, warmup=1)
    err = rel_l2(piped, ref)
    bubble = (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)
    log(f"parallel pipeline_parallel_encode S={PP_STAGES}, M={PP_MICRO}, 4 x "
        f"{PARALLEL_PP_SECONDS:.0f} s (T={ref.shape[1]}) on {name}: relative L2 {err:.3g} against "
        f"fastconformer_encode (tol {PIPE_TOL}); row 4 launched {pp_counts['ln_dense']} times "
        f"(2 x {cfg.num_layers} x M = {2 * cfg.num_layers * PP_MICRO}); launches "
        f"{ {k: pp_counts[k] for k in PACKED_ROUTE_KERNELS + ('fused_conv_module_ln',)} }; "
        f"CUDA-event ms {pp_ms:.2f} against the single-device encode {enc_ms:.2f}; bubble share "
        f"(S-1)/(M+S-1) = {bubble:.3f}; peak GiB {pp_peak}")
    check(pp_counts["ln_dense"] == 2 * cfg.num_layers * PP_MICRO,
          f"parallel: row 4 launched {pp_counts['ln_dense']} times in the pipeline")
    check(all(pp_counts[k] > 0 for k in PACKED_ROUTE_KERNELS + ("fused_conv_module_ln",)),
          f"parallel: the pipeline did not launch rows 2 and 4-7 {pp_counts}")
    check(err <= PIPE_TOL, f"parallel: pipeline encode relative L2 {err}")
    del ref, piped, staged, feats, wav
    steps["pipeline encode"] = time.perf_counter() - t0

    # 4. sequence parallel: 1 x 30 s over 2 entries, fp32, the plain impls
    t0 = time.perf_counter()
    plain = replace(cfg, compute_dtype="float32", attn_impl="xla", conv_impl="xla",
                    lnd_impl="xla")
    with torch.inference_mode():
        wav = torch.from_numpy(speech_like(PARALLEL_PP_SECONDS, seed=650)[None]).to(dev)
        feats, flens = log_mel_spectrogram(wav, torch.tensor([n], device=dev), model.fe_cfg)
        feats = torch.nn.functional.pad(feats, (0, 0, 0, feats.shape[1] % 2))  # frames even
        ops.reset_launch_counts()
        sp, _ = sequence_parallel_encode(model.params["encoder"], feats, flens, plain,
                                         make_mesh(1, 2, devices=two))
        sp_counts = sum(ops.launch_counts().values())
        whole, _ = fastconformer_encode(model.params["encoder"], feats, flens, plain)
    err = rel_l2(sp, whole)
    log(f"parallel sequence_parallel_encode over 2 entries, 1 x {PARALLEL_PP_SECONDS:.0f} s "
        f"(T={whole.shape[1]}, shards of {-(-whole.shape[1] // 2)} frames), fp32 plain impls on "
        f"{name}: relative L2 {err:.3g} against the unsplit plain encode (tol 1e-4); kernel "
        f"launches {sp_counts}")
    check(err <= 1e-4 and sp_counts == 0, f"parallel: sequence-parallel encode {err}, {sp_counts}")
    del model, sp, whole, feats, wav
    gc.collect()
    torch.cuda.empty_cache()
    steps["sequence-parallel encode"] = time.perf_counter() - t0

    # 5. training: the pipeline step and the dp x tp Trainer step
    t0 = time.perf_counter()
    enc_cfg, rnnt_cfg = train_configs()
    fe_cfg = nemo_frontend_config()
    params = train_params(0, enc_cfg, rnnt_cfg, dev)
    batch = train_batch(rnnt_cfg)
    loss_1, g_1, _, _ = train_grads(params, batch, fe_cfg, enc_cfg, rnnt_cfg, dev)
    spec = PipelineSpec(mesh=make_pipeline_mesh(PP_STAGES, devices=two), n_micro=2)
    loss_p, g_p, fwd_p, _ = train_grads(params, batch, fe_cfg, enc_cfg, rnnt_cfg, dev,
                                        pipeline=spec)
    dl = abs(loss_p.item() - loss_1.item()) / abs(loss_1.item())
    dg = rel_l2(g_p, g_1)
    del g_1, g_p
    gc.collect()
    log(f"parallel pipeline training step (S={PP_STAGES}, M=2, {TRAIN_B} x {TRAIN_SECONDS:.0f} s, "
        f"xlarge, remat) on {name}: loss {loss_p.item():.6f} against the single-device "
        f"{loss_1.item():.6f} (relative {dl:.3g}, tol 1e-5); gradients relative L2 {dg:.3g} "
        f"(tol 2.21e-3); forward launches { {k: fwd_p[k] for k in TRAIN_KERNELS} }")
    check(dl <= 1e-5 and dg <= 2.21e-3, f"parallel: pipeline training loss {dl}, grads {dg}")
    check(all(fwd_p[k] > 0 for k in TRAIN_KERNELS), f"parallel: pipeline training {fwd_p}")
    steps["pipeline training"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tcfg = TrainerConfig(warmup_steps=1, decay_steps=100, peak_lr=1e-4, log_every=1)
    single = Trainer(fe_cfg, enc_cfg, rnnt_cfg, tcfg, device=dev).init(params)
    loss_s = single.fit([batch], max_steps=1)[0]["loss"]
    del single
    gc.collect()
    piped_tr = Trainer(fe_cfg, enc_cfg, rnnt_cfg, tcfg, pipeline=spec).init(params)
    loss_pt = piped_tr.fit([batch], max_steps=1)[0]["loss"]
    del piped_tr
    gc.collect()
    mesh = make_mesh(2, 2, devices=four)
    reset_peaks(four)
    tp = Trainer(fe_cfg, enc_cfg, rnnt_cfg, tcfg, mesh=mesh).init(params)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    hist = tp.fit([batch], max_steps=1)
    torch.cuda.synchronize()
    tp_wall = time.perf_counter() - t1
    tp_counts = ops.launch_counts()
    tp_peak = entry_peaks(four)
    del tp, params
    gc.collect()
    torch.cuda.empty_cache()
    loss_tp = hist[0]["loss"]
    rel = abs(loss_tp - loss_s) / abs(loss_s)
    log(f"parallel Trainer(pipeline=S{PP_STAGES}) step: loss {loss_pt:.6f}; Trainer(mesh=2x2) "
        f"step on {name}: loss {loss_tp:.6f} against the single-device Trainer's {loss_s:.6f} "
        f"(relative {rel:.3g}, rtol 1e-4), grad norm {hist[0]['grad_norm']:.4f}, {tp_wall:.2f} s "
        f"(a first call); launches (forward and remat's recompute, model shards at N=2,048 and "
        f"4 heads) { {k: tp_counts[k] for k in TRAIN_KERNELS} }; peak GiB {tp_peak}")
    check(abs(loss_pt - loss_s) <= 1e-5 * abs(loss_s),
          f"parallel: Trainer(pipeline=) loss {loss_pt} against {loss_s}")
    check(rel <= 1e-4 and np.isfinite(hist[0]["grad_norm"]), f"parallel: dp x tp loss {rel}")
    check(all(tp_counts[k] > 0 for k in TRAIN_KERNELS), f"parallel: dp x tp launches {tp_counts}")
    steps["dp x tp training"] = time.perf_counter() - t0

    # 6. rows 4, 5 and 7 at the tensor-parallel shapes (B=2 rows of a data shard, T=188)
    t0 = time.perf_counter()
    rows = parallel_tp_checks(torch.device(dev), TRAIN_B // 2, int(TRAIN_SECONDS * 100) // 8 + 1)
    steps["tensor-parallel kernel checks"] = time.perf_counter() - t0
    counts = {tp: tp_counts[k] for tp, k in TP_ROWS.items()}
    log("parallel sub-step seconds: " + json.dumps({k: round(v, 2) for k, v in steps.items()})
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return rows, counts


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

    with phase("build"):
        t0 = time.perf_counter()
        _kernels.load_library()
        info = _kernels.build_info()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s): "
            f"{info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas: {line.strip()}")

    with phase("kernel_checks"):
        rows = kernel_checks(dev)
    with phase("main_path"):
        counts = main_path(dev, f"{smi}")
    with phase("nemo_beam40_phase"):
        nemo_beam40_phase(f"{smi}")
    with phase("head_width_encoder_check"):
        head_width_encoder_check()
    with phase("nemo_step_path"):
        counts.update(nemo_step_path(f"{smi}"))  # rows 12-13 take their launches from here
    with phase("k2_path"):
        counts.update(k2_path(f"{smi}"))
    with phase("k2_beam_path"):
        k2_beam_path(f"{smi}")
    with phase("espnet_path"):
        counts.update(espnet_path(f"{smi}"))
    with phase("serving_phase"):
        serving_phase(f"{smi}")
    with phase("decode_options_phase"):
        decode_options_phase(f"{smi}")
    with phase("converted_paths"):
        converted_paths(f"{smi}")
    with phase("avsr_phase"):
        avsr_phase(f"{smi}")
    with phase("training_phase"):
        training_phase(f"{smi}")
    with phase("streaming_phase"):
        stream_launches, model = streaming_phase(f"{smi}")
        counts["ln_dense"] += stream_launches  # row 4's launches include the streaming path's
    with phase("host_modules_phase"):
        host_modules_phase(f"{smi}", model)
    del model
    with phase("parallel_phase"):
        tp_rows, tp_counts = parallel_phase(f"{smi}")
    rows += tp_rows
    counts.update(tp_counts)  # the tensor-parallel rows' launches: the dp x tp step's
    log("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
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
