"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where no GPU is present. On a machine with one
(and without JAX, which ``tests/conftest.py`` imports) run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import ctypes

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch.ops import (
    add_ln, add_ln_plain, fused_conv_module, fused_conv_module_plain, joint_topm,
    joint_topm_plain, launch_counts, ln_dense, ln_dense_add, ln_dense_add_plain, ln_dense_plain,
    lstm_cell_step, lstm_cell_step_plain, relpos_attention_fused,
    relpos_attention_fused_packed, relpos_attention_fused_packed_plain,
    relpos_attention_fused_plain, reset_launch_counts, shared_rel_attention,
    shared_rel_attention_blockwise, shared_rel_attention_blockwise_plain,
    shared_rel_attention_plain, topm_logsoftmax, topm_logsoftmax_plain,
)
from reazonspeech_tpu_torch.ops._kernels import forced_tile_n, load_library
from reazonspeech_tpu_torch.ops.relpos_attention import (
    relpos_attention, relpos_attention_blockwise, relpos_attention_blockwise_plain,
    relpos_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0, dtype=torch.bfloat16, device="cuda"):
    return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)


@pytest.mark.parametrize("h,dh,t", [(8, 128, 376), (8, 128, 1000), (2, 64, 70), (8, 16, 33)])
def test_relpos_attention_kernel_matches_plain(dev, h, dh, t):
    """bf16 in and out: both round the probabilities to bf16 before p·v
    (the kernel before normalising, the twin after) and the output to bf16,
    so they agree to a few bf16 ulps (0.03 abs at |out| <= ~1). T=1000 is
    past the TPU kernel's cap (t_pad <= 512): the key loop has no cap."""
    gen = torch.Generator().manual_seed(t)
    b = 3
    q, k, v = (_rand(gen, b, t, h * dh, scale=0.5) for _ in range(3))
    pos = _rand(gen, 2 * t - 1, h, dh, scale=0.5)
    bu, bv = _rand(gen, h, dh, scale=0.1, dtype=torch.float32), _rand(
        gen, h, dh, scale=0.1, dtype=torch.float32)
    lengths = torch.tensor([t, max(t - 17, 1), 1], dtype=torch.int32, device=dev)
    got = relpos_attention_fused(q, k, v, pos, bu, bv, lengths, h)
    want = relpos_attention_fused_plain(q, k, v, pos, bu, bv, lengths, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 0.03


@pytest.mark.parametrize("t,k", [(376, 9), (45, 3)])
def test_conv_module_kernel_matches_plain(dev, t, k):
    """bf16 in and out, fp32 inside: a few bf16 ulps (0.03 abs)."""
    gen = torch.Generator().manual_seed(k)
    b, d = 2, 256
    f32 = torch.float32
    x = _rand(gen, b, t, d)
    args = (x, torch.tensor([t, t // 2], dtype=torch.int32, device=dev),
            _rand(gen, d, 2 * d, scale=d ** -0.5, dtype=f32),
            _rand(gen, 2 * d, scale=0.1, dtype=f32),
            _rand(gen, k, 1, d, scale=k ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            _rand(gen, d, d, scale=d ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32))
    got = fused_conv_module(*args)
    want = fused_conv_module_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 0.03


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [False, True])
def test_topm_kernel_matches_plain(dev, dtype, integer):
    """Indices equal (ties to the lowest index), log-probs to 1e-4."""
    gen = torch.Generator().manual_seed(int(integer))
    x = torch.randn((16, 3001), generator=gen) * 3.0
    if integer:
        x = torch.randint(-3, 4, (16, 3001), generator=gen).float()
    x = x.to(device=dev, dtype=dtype)
    got = topm_logsoftmax(x, 4, 3000)
    want = topm_logsoftmax_plain(x, 4, 3000)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


# (r, v, m, blank, dtype): m past the largest list (40: the rounds path) and
# V past one row part (the last block's merge), bf16 and fp32, m > V (the
# EXCLUDED pool after the labels)
TOPM_WIDE = [(16, 3001, 40, 3000, torch.float32), (16, 3001, 64, 0, torch.bfloat16),
             (4, 50000, 40, 0, torch.float32), (4, 50000, 64, 49999, torch.bfloat16),
             (3, 50000, 4, 17, torch.float32), (2, 8300, 8310, 8299, torch.float32),
             (2, 30, 40, 5, torch.float32)]


@pytest.mark.parametrize("r,v,m,blank,dtype", TOPM_WIDE)
def test_topm_kernel_wide_matches_plain(dev, r, v, m, blank, dtype):
    """Indices equal (the picks compare the logits themselves), log-probs to
    1e-4 (the log-sum-exp summed in another order)."""
    gen = torch.Generator().manual_seed(v + m)
    x = (torch.randn((r, v), generator=gen) * 3.0).to(device=dev, dtype=dtype)
    got = topm_logsoftmax(x, m, blank)
    want = topm_logsoftmax_plain(x, m, blank)
    torch.cuda.synchronize()
    assert got[1].shape == (r, m) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("v", [300, 20000])
def test_topm_kernel_excluded_pool(dev, v):
    """Rows with -inf, exactly -1e30 and few finite logits: past the finite
    labels the rounds take the JAX kernel's -1e30 pool (its lowest column),
    in one tile and across three."""
    gen = torch.Generator().manual_seed(v)
    x = torch.full((3, v), float("-inf"))
    x[:, 7::997] = torch.randn((3, len(range(7, v, 997))), generator=gen)
    x[0, 3] = x[1, v - 2] = -1e30
    x[2, 1::2] = -1e31
    x = x.to(dev)
    got = topm_logsoftmax(x, 30, 5)
    want = topm_logsoftmax_plain(x, 30, 5)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


def _device_kernels(fn, name, calls=10):
    """The device kernels named ``*name*`` that one fn() call runs
    (torch.profiler over ``calls`` calls; a profile that records none, which
    the tracer does now and then, is taken again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key)
        if n:
            return n / calls
    pytest.fail("the profiler recorded no device kernel")


def _check_topm(got, want):
    assert got[1].shape == want[1].shape and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


# m = 1, the served sizes (4, 20, 40) and one past each (41, 64: rounds)
TOPM_MS = [1, 4, 5, 20, 21, 40, 41, 64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", TOPM_MS)
def test_topm_kernel_list_sizes(dev, m, dtype):
    """Picks from keys (m <= 40) and the rounds path, on rows of one part
    (V = 3,001, not 16-byte aligned) and of 13 (V = 50,000: at m = 40 the
    merge's 520 slots are cut down a chunk at a time), blank last and
    first."""
    gen = torch.Generator().manual_seed(m)
    for r, v, blank in ((16, 3001, 3000), (3, 50000, 0)):
        x = (torch.randn((r, v), generator=gen) * 3.0).to(device=dev, dtype=dtype)
        _check_topm(topm_logsoftmax(x, m, blank), topm_logsoftmax_plain(x, m, blank))


@pytest.mark.parametrize("v", [3001, 50000])
@pytest.mark.parametrize("m", [4, 20, 40, 64])
def test_topm_kernel_integer_ties(dev, v, m):
    """Integer logits in [-3, 3]: every pick is a tie that the lowest column
    must win, across lanes, warps and (V = 50,000) blocks."""
    gen = torch.Generator().manual_seed(v + m)
    x = torch.randint(-3, 4, (4, v), generator=gen).float().to(dev)
    for blank in (0, v - 1):
        got = topm_logsoftmax(x, m, blank)
        _check_topm(got, topm_logsoftmax_plain(x, m, blank))
        assert (got[2][:, 1:] > got[2][:, :-1]).all()  # all tied at 3


@pytest.mark.parametrize("v", [300, 3001, 50000])
@pytest.mark.parametrize("m", [4, 30, 64])
def test_topm_kernel_all_excluded(dev, v, m):
    """Rows whose every value is <= -1e30 (-1e30, -1e31, -inf): no candidate,
    so every pick is the EXCLUDED pool's lowest column."""
    x = torch.full((3, v), -1e30)
    x[0, : v // 2] = float("-inf")
    x[1, 1::2] = -1e31
    x[2, :7] = -1e31
    x = x.to(dev)
    for blank in (0, 5, v - 1):
        got = topm_logsoftmax(x, m, blank)
        _check_topm(got, topm_logsoftmax_plain(x, m, blank))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,m", [(3001, 4), (3001, 20), (50000, 40), (50000, 64)])
def test_topm_kernel_unaligned_view(dev, v, m, dtype):
    """Logits that start one element past a 16-byte boundary: the scalar
    head, the vectors and the tail of every row shift."""
    gen = torch.Generator().manual_seed(v + m)
    x = _misaligned((torch.randn((5, v), generator=gen) * 3.0).to(device=dev, dtype=dtype))
    assert x.data_ptr() % 16
    _check_topm(topm_logsoftmax(x, m, 3), topm_logsoftmax_plain(x, m, 3))


@pytest.mark.parametrize("v,m", [(3001, 4), (2182, 20), (50000, 40), (50000, 64)])
def test_topm_kernel_one_launch_deterministic(dev, v, m):
    """One device kernel a call at every V, and two calls bit-equal (the
    last block's merge does not depend on which block finished last)."""
    gen = torch.Generator().manual_seed(v)
    x = (torch.randn((16, v), generator=gen) * 3.0).to(dev)
    reset_launch_counts()
    first = topm_logsoftmax(x, m, 0)
    assert launch_counts()["topm_logsoftmax"] == 1
    assert _device_kernels(lambda: topm_logsoftmax(x, m, 0), "topm_kernel") == 1
    for _ in range(3):
        again = topm_logsoftmax(x, m, 0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("v,m", [(3001, 4), (50000, 40), (50000, 64)])
def test_topm_kernel_two_streams(dev, v, m):
    """Two streams at once, each with its own inputs and workspace (tickets
    and partials): each result equals the twin's."""
    gen = torch.Generator().manual_seed(v + 1)
    xs = [(torch.randn((8, v), generator=gen) * 3.0).to(dev) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(topm_logsoftmax(xs[i], m, 0))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        want = topm_logsoftmax_plain(x, m, 0)
        for g in got:
            _check_topm(g, want)


def _bf16_tol(want):
    """2 bf16 ulps at the largest |value| (the kernel and the twin round at
    the same points; only their fp32 sums differ in order)."""
    return 2.0 * 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)


def _max_err(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    return (got.float() - want.float()).abs().max().item()


# (b, t, d, widths, act): nemo's serving shapes (B=4, T=401, D=1024: FFN-in
# and the packed q/k/v), espnet's (B=4, T=549, D=512), M = B·T of 1, 127
# and 129 (one row, one short of a 128-row tile, one past it), D from 128 to
# 2,048, segment widths of 64, 192 (a ragged column tile) and up, both
# activations, the odd T=33, and the streaming encoder's FFN-in (M = 16 and
# 64 rows of a 16-frame chunk)
LN_SHAPES = [(1, 16, 1024, (4096,), "swish"), (4, 16, 1024, (4096,), "swish"),
             (4, 401, 1024, (4096,), "swish"), (4, 401, 1024, (1024,) * 3, None),
             (4, 549, 512, (2048,), "swish"), (4, 549, 512, (512,) * 3, None),
             (1, 1, 128, (64,), "swish"), (1, 1, 1024, (1024,) * 3, None),
             (1, 127, 512, (192,), None), (1, 127, 2048, (4096,), "swish"),
             (1, 129, 2048, (64,), None), (1, 129, 128, (192,), "swish"),
             (4, 33, 128, (512,), "swish"), (4, 33, 128, (128,) * 3, None)]


def _ln_inputs(dev, b, t, d, widths, seed):
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    x = _rand(gen, b, t, d, dtype=f32) + 0.5
    g, b = 1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32)
    ws = tuple(_rand(gen, d, n, scale=0.5 * d ** -0.5) for n in widths)
    cs = tuple(_rand(gen, n, scale=0.1, dtype=f32) for n in widths)
    return gen, x, g, b, (ws if len(ws) > 1 else ws[0]), (cs if len(cs) > 1 else cs[0])


@pytest.mark.parametrize("bt,d,widths,act", [((b, t), d, w, a) for b, t, d, w, a in LN_SHAPES])
def test_ln_dense_kernel_matches_plain(dev, bt, d, widths, act):
    """bf16 out within 2 bf16 ulps of the twin at the largest |value|, with
    the GEMM's column tile chosen by the kernel and forced to 128 and 256."""
    _, x, g, b, w, c = _ln_inputs(dev, *bt, d, widths, seed=bt[1] + d)
    got = ln_dense(x, g, b, w, c, activation=act)
    want = ln_dense_plain(x, g, b, w, c, act)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= _bf16_tol(want)
    for tile_n in (128, 256):
        with forced_tile_n(tile_n):
            got = ln_dense(x, g, b, w, c, activation=act)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= _bf16_tol(want), tile_n


@pytest.mark.parametrize("bt,d,widths,act", [((b, t), d, w, a) for b, t, d, w, a in LN_SHAPES])
def test_ln_dense_add_kernel_matches_plain(dev, bt, d, widths, act):
    """The projection as ln_dense; the fp32 stream r + 0.5·delta to 1e-5."""
    gen, x, g, b, w, c = _ln_inputs(dev, *bt, d, widths, seed=bt[1] * d)
    delta = _rand(gen, *bt, d)
    got, got_x = ln_dense_add(x, delta, g, b, w, c, scale=0.5, activation=act)
    want, want_x = ln_dense_add_plain(x, delta, g, b, w, c, 0.5, act)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= _bf16_tol(want)
    assert _max_err(got_x, want_x) <= 1e-5


@pytest.mark.parametrize("t,d", [(401, 1024), (33, 128)])
def test_add_ln_kernel_matches_plain(dev, t, d):
    """fp32 out to 1e-4 (the statistics summed in another order); rows at
    or past each length exactly zero."""
    gen, x, g, b, _, _ = _ln_inputs(dev, 4, t, d, (64,), seed=t)
    y = _rand(gen, 4, t, d)
    lengths = torch.tensor([t, t - 13, 7, 1], dtype=torch.int32, device=dev)
    got = add_ln(x, y, lengths, g, b, scale=0.5)
    want = add_ln_plain(x, y, lengths, g, b, 0.5)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-4
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    assert not got[~valid].any().item()


@pytest.mark.parametrize("h,dh,t", [(8, 128, 401), (2, 64, 33)])
def test_packed_attention_kernel_matches_plain(dev, h, dh, t):
    """As the separate-input kernel: a few bf16 ulps (0.03 abs at |out| <= ~1)."""
    gen = torch.Generator().manual_seed(t)
    b = 4
    qkv = _rand(gen, b, t, 3 * h * dh, scale=0.5)
    pos = _rand(gen, 2 * t - 1, h, dh, scale=0.5)
    bu, bv = (_rand(gen, h, dh, scale=0.1, dtype=torch.float32) for _ in range(2))
    lengths = torch.tensor([t, max(t - 17, 1), 5, 1], dtype=torch.int32, device=dev)
    got = relpos_attention_fused_packed(qkv, pos, bu, bv, lengths, h)
    want = relpos_attention_fused_packed_plain(qkv, pos, bu, bv, lengths, h)
    torch.cuda.synchronize()
    assert got.shape == (b, t, h * dh)
    assert _max_err(got, want) <= 0.03


@pytest.mark.parametrize("t,d", [(401, 1024), (33, 128)])
def test_conv_module_ln_kernel_matches_plain(dev, t, d):
    """The in-kernel LayerNorm form on the raw fp32 stream: 0.03 abs, as the
    caller-side form."""
    gen = torch.Generator().manual_seed(d)
    f32, k = torch.float32, 9
    x = _rand(gen, 2, t, d, dtype=f32) + 1.0
    args = (x, torch.tensor([t, t // 2], dtype=torch.int32, device=dev),
            _rand(gen, d, 2 * d, scale=d ** -0.5, dtype=f32),
            _rand(gen, 2 * d, scale=0.1, dtype=f32),
            _rand(gen, k, 1, d, scale=k ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            _rand(gen, d, d, scale=d ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32))
    kw = dict(ln_scale=1.0 + _rand(gen, d, scale=0.1, dtype=f32),
              ln_bias=_rand(gen, d, scale=0.1, dtype=f32), compute_dtype=torch.bfloat16)
    got = fused_conv_module(*args, **kw)
    want = fused_conv_module_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 0.03


def test_wrong_inputs_raise(dev):
    """The wrappers refuse what the kernels do not take; nothing falls back."""
    _, x, g, b, w, c = _ln_inputs(dev, 4, 33, 128, (128,), seed=0)
    with pytest.raises(TypeError):
        ln_dense(x, g, b, w.float(), c)  # fp32 weights
    with pytest.raises(ValueError):
        ln_dense(x, g, b, w[:, :100].contiguous(), c[:100])  # width not a multiple of 8
    with pytest.raises(ValueError):  # D not a multiple of 8: TMA needs 16-byte rows
        ln_dense(x[..., :100].contiguous(), g[:100], b[:100], w[:100].contiguous(), c)
    with pytest.raises(ValueError):
        ln_dense(x, g, b, (w,) * 4, (c,) * 4)  # four segments
    with pytest.raises(ValueError):
        ln_dense(x, g, b, w, c, activation="relu")
    with pytest.raises(TypeError):
        ln_dense(x.to(torch.bfloat16), g, b, w, c)  # a bf16 stream
    with pytest.raises(TypeError):
        ln_dense_add(x, x, g, b, w, c)  # an fp32 delta
    lengths = torch.ones(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        add_ln(x, x.to(torch.bfloat16), lengths, g, b, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        add_ln(x, x, lengths, g, b)  # an fp32 branch output
    with pytest.raises(ValueError):
        relpos_attention_fused_packed(x.to(torch.bfloat16)[..., :100], None, None, None, None, 2)


@pytest.mark.parametrize("lnd_impl,kernels", [
    ("pallas", ("ln_dense", "ln_dense_add", "relpos_attention_fused_packed",
                "fused_conv_module_ln", "add_ln", "topm_logsoftmax")),
    ("xla", ("relpos_attention_fused", "fused_conv_module", "topm_logsoftmax")),
])
def test_tiny_model_runs_the_kernels(dev, lnd_impl, kernels):
    """The slice end to end on the card at a tiny width, in the serving
    configuration (lnd_impl="pallas") and the earlier one: every kernel of
    each runs."""
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
    from reazonspeech_tpu_torch.nemo.asr import audio_from_numpy, load_model, transcribe

    enc = FastConformerConfig.tiny(d_model=128, num_heads=8, attn_impl="pallas",
                                    conv_impl="pallas", lnd_impl=lnd_impl)
    model = load_model("cuda", checkpoint="random", enc_cfg=enc,
                       rnnt_cfg=RNNTConfig.tiny(enc_dim=128))
    wav = (np.random.default_rng(0).standard_normal(48000) * 0.1).astype(np.float32)
    reset_launch_counts()
    ret = transcribe(model, audio_from_numpy(wav, 16000))
    assert isinstance(ret.text, str)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts


# (g, t, qd, dv, heads): the k2 main path's per-head and nonlin applications
# (stack 0 and 3 of the 32 s bucket), an odd small shape, and the tiny
# configuration's qd=8 (zero-padded to 32 inside the kernel)
SHARED_SHAPES = [(16, 1596, 32, 12, 4), (4, 200, 32, 576, 1), (6, 77, 32, 4, 3),
                 (4, 130, 8, 144, 2)]


def _shared_inputs(dev, g, t, qd, dv, heads, seed):
    gen = torch.Generator().manual_seed(seed)
    lengths = [t, 1] + [max(1, t - 37 * i) for i in range(2, g)]
    return (_rand(gen, g, t, qd, scale=0.5), _rand(gen, g, t, qd, scale=0.5),
            _rand(gen, g, t, 4), _rand(gen, heads, 2 * t - 1, 4), _rand(gen, g, t, dv),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("g,t,qd,dv,heads", SHARED_SHAPES)
def test_shared_attention_kernel_matches_plain(dev, g, t, qd, dv, heads):
    """fp32 out: the kernel and the twin round the normalised probabilities
    to bf16 at the same points; an fp32 sum order or expf ulp can move one
    probability by a bf16 ulp: 2e-3 abs at |v| <= ~4."""
    args = _shared_inputs(dev, g, t, qd, dv, heads, seed=t + dv)
    got = shared_rel_attention(*args, heads=heads)
    want = shared_rel_attention_plain(*args, heads=heads)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (g, t, dv)
    assert _max_err(got, want) <= 2e-3


@pytest.mark.parametrize("g,t,qd,dv,heads", SHARED_SHAPES + [(4, 3196, 32, 12, 4)])
def test_shared_attention_blockwise_kernel_matches_plain(dev, g, t, qd, dv, heads):
    """The streamed entry against the twin's block loop at the kernel's
    64-key tiles (the same online-softmax rounding points): 2e-3 abs."""
    args = _shared_inputs(dev, g, t, qd, dv, heads, seed=t * dv)
    got = shared_rel_attention_blockwise(*args, heads=heads)
    want = shared_rel_attention_blockwise_plain(*args, heads=heads, block=64)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 2e-3


# (g, t, qd, pd, dv, heads, lengths): T not a multiple of 64; lengths 0, 1
# and T; G = 1; dv = 12, 144 and 576 (the nonlin applications: one chunk of
# 192 value columns, and three); dv = 6, 13 and 198, not multiples of 4 (V
# staged element by element; 198 in a full chunk and one of 6 columns); qd =
# 8 and 16 (zero-padded to 32); pd = 2 and 8; k2's stack 0 and the streamed
# entry's T=3196
SHARED_WIDE = [(3, 77, 32, 4, 12, 3, [0, 1, 77]), (1, 200, 32, 4, 12, 1, [200]),
               (2, 130, 32, 4, 144, 1, [130, 0]), (2, 200, 32, 4, 576, 1, [1, 200]),
               (4, 1596, 32, 4, 12, 4, [1596, 0, 1, 1000]), (1, 3196, 32, 4, 144, 1, [3196]),
               (2, 70, 8, 2, 4, 2, [70, 3]), (2, 70, 16, 8, 12, 1, [70, 64]),
               (2, 100, 32, 4, 6, 2, [100, 37]), (3, 90, 32, 4, 13, 1, [0, 90, 5]),
               (2, 210, 32, 4, 198, 1, [210, 71]),
               # widths past the published ones (q·kᵀ in up to 8 k16 steps, qp
               # in shared memory): qd = 64, 12, 48, 128 and odd 7; pd = 9,
               # 16, 32 and 3
               (2, 77, 64, 4, 12, 2, [77, 0]), (3, 70, 12, 9, 12, 1, [70, 1, 33]),
               (2, 130, 48, 16, 144, 1, [130, 5]), (2, 70, 128, 32, 12, 2, [70, 64]),
               (2, 33, 7, 3, 13, 1, [33, 0])]


@pytest.mark.parametrize("entry", ["single", "streamed"])
@pytest.mark.parametrize("g,t,qd,pd,dv,heads,lens", SHARED_WIDE)
def test_shared_attention_wide_kernel_matches_plain(dev, entry, g, t, qd, pd, dv, heads, lens):
    """Both entries against their twins (the streamed one at 64-key blocks),
    fp32 out within 2e-3 as above. A row of length 0 is garbage to
    the caller; the kernel gives every key in [0, T) the same score, a
    uniform row, as the single-pass twin does (the streamed twin's padded
    keys would join it)."""
    gen = torch.Generator().manual_seed(t * dv + pd)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (_rand(gen, g, t, qd, scale=0.5), _rand(gen, g, t, qd, scale=0.5),
            _rand(gen, g, t, pd), _rand(gen, heads, 2 * t - 1, pd), _rand(gen, g, t, dv),
            lengths)
    want = shared_rel_attention_plain(*args, heads=heads)
    fn = shared_rel_attention
    if entry == "streamed":
        fn = shared_rel_attention_blockwise
        want = torch.where((lengths == 0)[:, None, None], want,
                           shared_rel_attention_blockwise_plain(*args, heads=heads, block=64))
    got = fn(*args, heads=heads)
    torch.cuda.synchronize()
    assert got.shape == (g, t, dv) and _max_err(got, want) <= 2e-3


def test_shared_attention_wrong_inputs_raise(dev):
    args = list(_shared_inputs(dev, 2, 33, 32, 12, 1, seed=0))
    with pytest.raises(TypeError):
        shared_rel_attention(*([args[0].float()] + args[1:]))  # fp32 q
    with pytest.raises(ValueError):
        shared_rel_attention(*(args[:3] + [args[3][:, :10]] + args[4:]))  # short pos table
    with pytest.raises(ValueError):
        shared_rel_attention_blockwise(*(args[:4] + [args[4][:, :, :5]] + args[5:]))  # not contiguous
    wide = list(_shared_inputs(dev, 2, 33, 64, 12, 1, seed=0))
    got = shared_rel_attention(*wide)  # qd=64: taken since the kernel goes to 128
    torch.cuda.synchronize()
    assert _max_err(got, shared_rel_attention_plain(*wide)) <= 2e-3
    wide = list(_shared_inputs(dev, 2, 33, 129, 12, 1, seed=0))
    with pytest.raises(ValueError, match="qd=129"):
        shared_rel_attention(*wide)  # past the kernel's 128


def _misaligned(t):
    """A copy of ``t`` that is contiguous but starts one element past a
    16-byte boundary (a view at storage offset 1)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("arg", ["conv bn_scale", "conv ln_scale", "attention q",
                                 "attention pos", "relpos qu", "relpos packed qkv"])
def test_misaligned_inputs_raise(dev, arg):
    """The conv module's per-channel vectors and the two attention kernels'
    inputs are read with 16-byte (and 8-byte) loads: a view that is not
    16-byte aligned is refused with a ValueError before any launch, and the
    card stays usable."""
    gen = torch.Generator().manual_seed(7)
    f32 = torch.float32
    if arg.startswith("conv"):
        b, t, d, k = 1, 8, 64, 9
        args = [_rand(gen, b, t, d, dtype=f32), torch.tensor([t], dtype=torch.int32, device=dev),
                _rand(gen, d, 2 * d, scale=0.1, dtype=f32), _rand(gen, 2 * d, dtype=f32),
                _rand(gen, k, 1, d, dtype=f32), _rand(gen, d, dtype=f32),
                _rand(gen, d, dtype=f32), _rand(gen, d, dtype=f32),
                _rand(gen, d, d, scale=0.1, dtype=f32), _rand(gen, d, dtype=f32)]
        kw = dict(ln_scale=_rand(gen, d, dtype=f32), ln_bias=_rand(gen, d, dtype=f32),
                  compute_dtype=torch.bfloat16)
        if arg == "conv bn_scale":
            args[6] = _misaligned(args[6].to(f32))
        else:
            kw["ln_scale"] = _misaligned(kw["ln_scale"])
        with pytest.raises(ValueError, match="16-byte aligned"):
            fused_conv_module(*args, **kw)
    elif arg == "relpos qu":
        args = list(_bhtd_inputs(dev, 2, 2, 64, 33, seed=0))
        args[0] = _misaligned(args[0])
        with pytest.raises(ValueError, match="16-byte aligned"):
            relpos_attention(*args)
    elif arg == "relpos packed qkv":
        qkv = _misaligned(_rand(gen, 2, 33, 3 * 128, scale=0.5))
        pos = _rand(gen, 65, 2, 64)
        bu, bv = (_rand(gen, 2, 64, dtype=f32) for _ in range(2))
        lengths = torch.tensor([33, 5], dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="16-byte aligned"):
            relpos_attention_fused_packed(qkv, pos, bu, bv, lengths, 2)
    else:
        args = list(_shared_inputs(dev, 2, 33, 32, 12, 1, seed=0))
        i = 0 if arg == "attention q" else 3
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            shared_rel_attention(*args)
    args = _shared_inputs(dev, 2, 33, 32, 12, 1, seed=0)
    got = shared_rel_attention(*args)
    torch.cuda.synchronize()
    assert _max_err(got, shared_rel_attention_plain(*args)) <= 2e-3


def test_tiny_k2_model_runs_both_entries(dev, monkeypatch):
    """The k2 path end to end on the card at a tiny width: the single-pass
    entry, and the streamed one with the dispatch threshold lowered."""
    from reazonspeech_tpu_torch.k2.asr import audio_from_numpy, transcribe
    from reazonspeech_tpu_torch.k2.asr.model import ZipformerConfig, load_model_container
    from reazonspeech_tpu_torch.models import zipformer as zf

    model = load_model_container(checkpoint="random", device="cuda",
                                 enc_cfg=ZipformerConfig.tiny(attn_impl="pallas"))
    wav = (np.random.default_rng(0).standard_normal(48000) * 0.1).astype(np.float32)
    dispatch = zf._shared_attn_kernel
    # stack 0 (T=196 of the 4 s bucket) past the threshold, the others not
    monkeypatch.setattr(zf, "_shared_attn_kernel", lambda t: dispatch(t * 11))
    reset_launch_counts()
    ret = transcribe(model, audio_from_numpy(wav, 16000))
    assert isinstance(ret.text, str)
    counts = launch_counts()
    assert counts["shared_rel_attention"] > 0 and counts["shared_rel_attention_blockwise"] > 0


# (b, h, dh, t): espnet's 20 s window (B·H = 8 and 32, T=549), an odd small
# shape, nemo's head size, and espnet's 45 s input (T=1149)
BHTD_SHAPES = [(1, 8, 64, 549), (4, 8, 64, 549), (3, 2, 16, 70), (2, 8, 128, 130),
               (1, 8, 64, 1149)]


def _bhtd_inputs(dev, b, h, dh, t, seed):
    gen = torch.Generator().manual_seed(seed)
    qu, qv, k, v = (_rand(gen, b, h, t, dh, scale=0.5) for _ in range(4))
    pos = _rand(gen, 2 * t - 1, h, dh, scale=0.5)
    lengths = torch.tensor([t] + [max(1, t - 37 * i) for i in range(1, b)], dtype=torch.int32,
                           device=dev)
    return qu, qv, k, v, pos, lengths


@pytest.mark.parametrize("b,h,dh,t", BHTD_SHAPES)
def test_relpos_attention_bhtd_kernel_matches_plain(dev, b, h, dh, t):
    """The single-pass entry (two key sweeps, probabilities normalised before
    their bf16 cast, as the twin) and the streamed entry (64-key online
    softmax, against the twin's block loop at block=64): fp32 out within
    2e-3 abs, one bf16 ulp of a probability times |v| <= ~2 on a few keys."""
    args = _bhtd_inputs(dev, b, h, dh, t, seed=t + b)
    got = relpos_attention(*args)
    want = relpos_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, h, t, dh)
    assert _max_err(got, want) <= 2e-3
    got = relpos_attention_blockwise(*args)
    want = relpos_attention_blockwise_plain(*args, block=64)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 2e-3


def test_relpos_attention_bhtd_wrong_inputs_raise(dev):
    qu, qv, k, v, pos, lengths = _bhtd_inputs(dev, 2, 2, 16, 33, seed=0)
    with pytest.raises(TypeError):
        relpos_attention(qu.float(), qv, k, v, pos, lengths)  # fp32 qu
    with pytest.raises(ValueError):
        relpos_attention_blockwise(qu, qv, k, v, pos[:10], lengths)  # short pos table
    wide = torch.zeros((2, 2, 33, 257), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="past the kernel's 256"):
        relpos_attention(wide, wide, wide, wide, pos, lengths)


# (dh, t): head widths that are not multiples of 16 or past 128 (zero-padded
# to 16, 48, 48, 80 and 96, staged by cp.async in 16-, 8- and 16-byte
# copies; 192 and 256 by TMA into the 256-column instance, 192 through a
# box past dh, both in two blocks of 128 value columns), at T = 1 and T =
# 77 (not a multiple of 64), on every entry; lengths T, 0 and 1
HEAD_DIM_CASES = [(dh, t) for dh in (8, 36, 44, 80, 96, 192, 256) for t in (1, 77)]


@pytest.mark.parametrize("entry", ["fused", "packed", "single", "streamed"])
@pytest.mark.parametrize("dh,t", HEAD_DIM_CASES)
def test_relpos_attention_head_dims_match_plain(dev, entry, dh, t):
    """Each of the kernel's four entries against its twin at head widths the
    JAX kernels take (bf16 out within 0.03, fp32 out within 2e-3, as the
    tests above). A length of 0 scores every key alike (a uniform row); the
    streamed twin's padded keys would join that row, so there the kernel is
    held to the single-pass twin. 16 heads of dh = 8 (the fused route's
    packing), else 2."""
    gen = torch.Generator().manual_seed(dh * t)
    b, h = 3, 16 if dh == 8 else 2
    lengths = torch.tensor([t, 0, 1], dtype=torch.int32, device=dev)
    pos = _rand(gen, 2 * t - 1, h, dh, scale=0.5)
    if entry in ("fused", "packed"):
        bu, bv = (_rand(gen, h, dh, scale=0.1, dtype=torch.float32) for _ in range(2))
        qkv = _rand(gen, b, t, 3 * h * dh, scale=0.5)
        if entry == "packed":
            got = relpos_attention_fused_packed(qkv, pos, bu, bv, lengths, h)
            want = relpos_attention_fused_packed_plain(qkv, pos, bu, bv, lengths, h)
        else:
            q, k, v = (x.contiguous() for x in qkv.chunk(3, dim=-1))
            got = relpos_attention_fused(q, k, v, pos, bu, bv, lengths, h)
            want = relpos_attention_fused_plain(q, k, v, pos, bu, bv, lengths, h)
        tol = 0.03
    else:
        args = tuple(_rand(gen, b, h, t, dh, scale=0.5) for _ in range(4)) + (pos, lengths)
        want = relpos_attention_plain(*args)
        if entry == "single":
            got = relpos_attention(*args)
        else:
            got = relpos_attention_blockwise(*args)
            want = torch.where((lengths == 0)[:, None, None, None], want,
                               relpos_attention_blockwise_plain(*args, block=64))
        tol = 2e-3
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("in_ln", [False, True])
@pytest.mark.parametrize("t,d,k", [(549, 512, 31), (45, 128, 31), (33, 256, 9)])
def test_conv_module_layer_norm_kernel_matches_plain(dev, in_ln, t, d, k):
    """norm="layer" (espnet), with the pre-module LayerNorm by the caller and
    inside: bf16 out, fp32 inside, 0.03 abs as the folded forms."""
    gen = torch.Generator().manual_seed(t + d)
    f32 = torch.float32
    x = _rand(gen, 2, t, d, dtype=f32) + 1.0
    if not in_ln:
        x = x.to(torch.bfloat16)
    args = (x, torch.tensor([t, t // 2], dtype=torch.int32, device=dev),
            _rand(gen, d, 2 * d, scale=d ** -0.5, dtype=f32),
            _rand(gen, 2 * d, scale=0.1, dtype=f32),
            _rand(gen, k, 1, d, scale=k ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            _rand(gen, d, d, scale=d ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32))
    kw = dict(norm="layer")
    if in_ln:
        kw.update(ln_scale=1.0 + _rand(gen, d, scale=0.1, dtype=f32),
                  ln_bias=_rand(gen, d, scale=0.1, dtype=f32), compute_dtype=torch.bfloat16)
    reset_launch_counts()
    got = fused_conv_module(*args, **kw)
    want = fused_conv_module_plain(*args, **kw)
    torch.cuda.synchronize()
    entry = "fused_conv_module_ln_layer" if in_ln else "fused_conv_module_layer"
    assert launch_counts()[entry] == 1
    assert _max_err(got, want) <= 0.03


# (b, t, d, norm): M = B·T of 1, 127 and 129 (one short of a 128-row tile
# and one past it) and 1,604 (nemo's bucket); D = 200 (not a multiple of
# 64), 1,024 and, with norm="layer", 2,560 (past the former cap of 2,048)
CONV_WIDE = [(1, 1, 200, "folded"), (1, 127, 1024, "folded"), (3, 43, 200, "layer"),
             (4, 401, 1024, "folded"), (1, 129, 2560, "layer"), (4, 401, 200, "folded"),
             (1, 127, 2560, "layer")]


@pytest.mark.parametrize("in_ln", [False, True])
@pytest.mark.parametrize("b,t,d,norm", CONV_WIDE)
def test_conv_module_wide_kernel_matches_plain(dev, b, t, d, norm, in_ln):
    """Both norms with the pre-module LayerNorm by the caller and inside:
    bf16 out, fp32 inside, 0.03 abs as at the paths' shapes, with the GEMMs'
    column tile chosen per shape and forced to 128 and to 256. Lengths
    ragged, 0 included."""
    gen = torch.Generator().manual_seed(b * t + d)
    f32, k = torch.float32, 9 if norm == "folded" else 31
    x = _rand(gen, b, t, d, dtype=f32) + 1.0
    if not in_ln:
        x = x.to(torch.bfloat16)
    lens = [t, t // 2, 0, max(t - 13, 0)][:b]
    args = (x, torch.tensor(lens, dtype=torch.int32, device=dev),
            _rand(gen, d, 2 * d, scale=d ** -0.5, dtype=f32),
            _rand(gen, 2 * d, scale=0.1, dtype=f32),
            _rand(gen, k, 1, d, scale=k ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            _rand(gen, d, d, scale=d ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32))
    kw = dict(norm=norm)
    if in_ln:
        kw.update(ln_scale=1.0 + _rand(gen, d, scale=0.1, dtype=f32),
                  ln_bias=_rand(gen, d, scale=0.1, dtype=f32), compute_dtype=torch.bfloat16)
    want = fused_conv_module_plain(*args, **kw)
    for tile_n in (0, 128, 256):
        with forced_tile_n(tile_n):
            got = fused_conv_module(*args, **kw)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= 0.03, tile_n


def test_tiny_espnet_model_runs_the_kernels(dev, monkeypatch):
    """The espnet path end to end on the card at a tiny width (2 heads of
    dh=64): the packed route on the 20 s find_blank pass (T=499), the
    [B, H, T, dh] single-pass route on the 22 s window (T=549), the streamed
    entry there with the dispatch threshold lowered, the layer-norm conv
    module, and the top-m kernel in Graves beam search."""
    from reazonspeech_tpu_torch.espnet.asr import audio_from_numpy, load_model, transcribe
    from reazonspeech_tpu_torch.models import fastconformer as fc
    from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config

    enc = espnet_encoder_config(num_layers=2, d_model=128, num_heads=2, subsampling_channels=32,
                                attn_impl="pallas", conv_impl="pallas", lnd_impl="pallas")
    model = load_model("cuda", checkpoint="random", enc_cfg=enc, beam_size=4)
    wav = (np.random.default_rng(0).standard_normal(24 * 16000) * 0.1).astype(np.float32)
    reset_launch_counts()
    ret = transcribe(model, audio_from_numpy(wav, 16000))
    assert isinstance(ret.text, str)
    counts = launch_counts()
    for name in ("relpos_attention", "relpos_attention_fused_packed", "ln_dense_add", "add_ln",
                 "fused_conv_module_ln_layer", "ln_dense", "topm_logsoftmax"):
        assert counts[name] > 0, counts
    monkeypatch.setattr(fc, "_SINGLE_PASS_MAX_T", 500)
    reset_launch_counts()
    model.decode_single(wav[:21 * 16000])
    assert launch_counts()["relpos_attention_blockwise"] > 0


# (r, h, j, v, blank, activation, m): nemo ALSD (beam 4 x 4 lanes), espnet
# Graves (4 lanes, beam 20), k2 ALSD, then ragged R on nemo's and espnet's
# widths, and more rows than the kernels' 16-row tile
JOINT_SHAPES = [(16, 640, 640, 3001, 3000, "relu", 4), (4, 256, 256, 2182, 0, "tanh", 20),
                (16, 512, 512, 2179, 0, "tanh", 4), (1, 640, 640, 3001, 3000, "relu", 4),
                (5, 256, 256, 2182, 0, "tanh", 20), (16, 256, 256, 2182, 2181, "sigmoid", 20),
                (37, 128, 96, 301, 7, "relu", 5),
                # past the old caps: m = 40 and 64, V = 50,000, H = J = 3,072 (the
                # depth in two chunks), and widths that are not multiples of 4
                (16, 3072, 3072, 3001, 3000, "relu", 40), (4, 256, 256, 50000, 0, "tanh", 64),
                (16, 640, 640, 50000, 49999, "relu", 40), (5, 130, 258, 301, 7, "sigmoid", 5)]


def _joint_inputs(dev, r, h, j, v, seed, act="tanh", blank=0, m=1):
    """Random fp32 inputs, redrawn until the m + 1 best labels of every row
    are 1e-5 apart in float64: no near-tie that two fp32 summation orders
    could break differently, so the kernel's picks must equal the twin's."""
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    while True:
        args = (_rand(gen, h, j, scale=h ** -0.5, dtype=f32), _rand(gen, j, scale=0.1, dtype=f32),
                _rand(gen, j, v, scale=j ** -0.5, dtype=f32), _rand(gen, v, scale=0.1, dtype=f32),
                _rand(gen, r, j, dtype=f32), _rand(gen, r, h, dtype=f32))
        wp, bp, wo, bo, enc, dec = (a.double() for a in args)
        act_fn = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}[act]
        logits = act_fn(enc + (dec @ wp + bp)) @ wo + bo
        logits[:, blank] = -1e30
        best = logits.topk(m + 1, dim=1).values
        if (best[:, :-1] - best[:, 1:]).min() > 1e-5:
            return args


@pytest.mark.parametrize("r,h,j,v,blank,act,m", JOINT_SHAPES)
def test_joint_topm_kernel_matches_plain(dev, r, h, j, v, blank, act, m):
    """fp32: indices equal, log-probs within 1e-5 (the sums run in another
    order: over 32-column tiles and 8 slices of the depth)."""
    args = _joint_inputs(dev, r, h, j, v, seed=r * v + m, act=act, blank=blank, m=m)
    kw = dict(activation=act, compute_dtype="float32")
    reset_launch_counts()
    got = joint_topm(*args, m, blank, **kw)
    want = joint_topm_plain(*args, m, blank, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["joint_topm"] == 1
    assert got[2].dtype == torch.int32 and got[1].shape == (r, m)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert _max_err(g, w) <= 1e-5


@pytest.mark.parametrize("blank", [0, 2181])
def test_joint_topm_kernel_ties_to_lowest_index(dev, blank):
    """Exact ties: a zero output projection leaves logits = b_out, integers
    in [-3, 3], so every top-m pick is a tie the lowest column must win."""
    w_pred, b_pred, w_out, _, enc, dec = _joint_inputs(dev, 4, 256, 256, 2182, seed=blank)
    gen = torch.Generator().manual_seed(1)
    b_out = torch.randint(-3, 4, (2182,), generator=gen).to(device=dev, dtype=torch.float32)
    args = (w_pred, b_pred, torch.zeros_like(w_out), b_out, enc, dec)
    got = joint_topm(*args, 20, blank, activation="tanh", compute_dtype="float32")
    want = joint_topm_plain(*args, 20, blank, activation="tanh", compute_dtype="float32")
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    assert (got[2][:, 1:] > got[2][:, :-1]).all()  # all tied at 3: increasing columns


@pytest.mark.parametrize("m", [1, 4, 5, 20, 21, 40, 41])
@pytest.mark.parametrize("r,h,v,blank,act", [(16, 640, 3001, 3000, "relu"),
                                             (4, 256, 2182, 0, "tanh")])
def test_joint_topm_kernel_list_sizes(dev, r, h, v, blank, act, m):
    """The served sizes and one past each, at nemo's and espnet's shapes:
    the merge's slots (94 or 69 tiles of min(m, 32)) in one chunk of keys,
    or cut down a chunk at a time past 512 (m >= 20)."""
    args = _joint_inputs(dev, r, h, h, v, seed=v + m, act=act, blank=blank, m=m)
    kw = dict(activation=act, compute_dtype="float32")
    got = joint_topm(*args, m, blank, **kw)
    want = joint_topm_plain(*args, m, blank, **kw)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert _max_err(g, w) <= 1e-5


@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("v", [3001, 2182])
def test_joint_topm_kernel_integer_ties_across_tiles(dev, v, m):
    """Exact ties across tiles and merge chunks: logits = b_out, integers in
    [-3, 3], blank first and last."""
    w_pred, b_pred, w_out, _, enc, dec = _joint_inputs(dev, 16, 256, 256, v, seed=v)
    gen = torch.Generator().manual_seed(m)
    b_out = torch.randint(-3, 4, (v,), generator=gen).to(device=dev, dtype=torch.float32)
    args = (w_pred, b_pred, torch.zeros_like(w_out), b_out, enc, dec)
    for blank in (0, v - 1):
        got = joint_topm(*args, m, blank, activation="relu", compute_dtype="float32")
        want = joint_topm_plain(*args, m, blank, activation="relu", compute_dtype="float32")
        assert torch.equal(got[2], want[2])
        assert (got[2][:, 1:] > got[2][:, :-1]).all()


def test_joint_topm_kernel_excluded_pool(dev):
    """Logits = b_out of -1e30 and -1e31 but for 3 finite columns: past them
    every pick is the EXCLUDED pool's lowest column."""
    w_pred, b_pred, w_out, _, enc, dec = _joint_inputs(dev, 4, 256, 256, 2182, seed=3)
    b_out = torch.full((2182,), -1e30)
    b_out[1::2] = -1e31
    b_out[[100, 1500, 2000]] = torch.tensor([0.5, -2.0, 1.0])
    args = (w_pred, b_pred, torch.zeros_like(w_out), b_out.to(dev), enc, dec)
    for m in (4, 30):
        got = joint_topm(*args, m, 7, activation="tanh", compute_dtype="float32")
        want = joint_topm_plain(*args, m, 7, activation="tanh", compute_dtype="float32")
        assert torch.equal(got[2], want[2]) and (got[2][:, 3:] == 0).all()
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("r,h,v,m", [(16, 640, 3001, 4), (4, 256, 2182, 20),
                                     (16, 640, 50000, 40)])
def test_joint_topm_kernel_launches_deterministic(dev, r, h, v, m):
    """At most two device kernels a call (no merge launch); calls bit-equal
    (the last block's merge does not depend on which block finished last)."""
    args = _joint_inputs(dev, r, h, h, v, seed=r + v, blank=0, m=m)
    kw = dict(activation="tanh", compute_dtype="float32")
    reset_launch_counts()
    first = joint_topm(*args, m, 0, **kw)
    assert launch_counts()["joint_topm"] == 1
    assert _device_kernels(lambda: joint_topm(*args, m, 0, **kw), "joint_") <= 2
    for _ in range(3):
        again = joint_topm(*args, m, 0, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_joint_topm_kernel_two_streams(dev):
    """Two streams at once, each with its own inputs and workspace."""
    args = [_joint_inputs(dev, 16, 640, 640, 3001, seed=s, blank=3000, m=4) for s in (1, 2)]
    kw = dict(activation="relu", compute_dtype="float32")
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(joint_topm(*args[i], 4, 3000, **kw))
    torch.cuda.synchronize()
    for a, got in zip(args, outs):
        want = joint_topm_plain(*a, 4, 3000, **kw)
        for g in got:
            assert torch.equal(g[2], want[2]) and _max_err(g[1], want[1]) <= 1e-5


# (r, h_in, h): nemo ALSD, espnet Graves, ragged R, more rows than a tile,
# a depth of 3,072, widths that are not multiples of 4, and nemo's width at
# ALSD beam 40 x 4 lanes and beam 10 x 4 (every row tile on one W slice)
LSTM_SHAPES = [(16, 640, 640), (4, 256, 256), (1, 640, 640), (5, 256, 256), (37, 128, 384),
               (16, 1536, 1536), (5, 1536, 1536), (4, 130, 258), (160, 640, 640),
               (40, 640, 640)]


def _lstm_inputs(r, h_in, h, seed):
    """fp32 inputs; past a depth of 1,280 (nemo's) the weights shrink by
    sqrt(1280 / depth), so that the gates keep the spread they have at the
    paths' shapes."""
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    scale = 0.1 * min(1.0, (1280 / (h_in + h)) ** 0.5)
    return (_rand(gen, h_in, 4 * h, scale=scale, dtype=f32),
            _rand(gen, h, 4 * h, scale=scale, dtype=f32), _rand(gen, 4 * h, scale=0.1, dtype=f32),
            _rand(gen, r, h_in, dtype=f32), _rand(gen, r, h, dtype=f32),
            _rand(gen, r, h, dtype=f32))


def _check_lstm(got, args):
    """h' and c' within 1e-5 of the twin (the gate sums in another order)
    and of torch.lstm_cell, the same cell with the weights as [4H, in]."""
    w_ih, w_hh, bias, x, hp, cp = args
    want = lstm_cell_step_plain(*args, compute_dtype="float32")
    lib = torch.lstm_cell(x, (hp, cp), w_ih.t().contiguous(), w_hh.t().contiguous(), bias,
                          torch.zeros_like(bias))
    torch.cuda.synchronize()
    for g, w, ref in zip(got, want, lib):
        assert g.shape == hp.shape and g.dtype == torch.float32
        assert _max_err(g, w) <= 1e-5
        assert _max_err(g, ref) <= 1e-5


@pytest.mark.parametrize("r,h_in,h", LSTM_SHAPES)
def test_lstm_cell_kernel_matches_plain(dev, r, h_in, h):
    """fp32, one launch a call, within 1e-5 of the twin and of
    torch.lstm_cell; repeated calls bit-equal (the sums run in a fixed
    order, with no atomics)."""
    args = _lstm_inputs(r, h_in, h, seed=r + h)
    reset_launch_counts()
    got = lstm_cell_step(*args, compute_dtype="float32")
    assert launch_counts()["lstm_cell_step"] == 1
    _check_lstm(got, args)
    for _ in range(3):
        again = lstm_cell_step(*args, compute_dtype="float32")
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# (r, h_in, h, ranks, fills): the kernel's splits, reached through the
# widths: 3 and 5 ranks (the pushes one float at a time, also at widths not
# multiples of 4), 6 (uneven units a rank), the deepest slices the ring
# holds whole (11 stages; 10 at widths not multiples of 4) and the stages
# through the ring in two fills a row tile past them (W copied again for
# each row tile), over several tiles
LSTM_SPLITS = [(4, 64, 32, 3, 1), (4, 96, 64, 5, 1), (5, 66, 34, 5, 1), (16, 64, 128, 6, 1),
               (40, 1408, 1408, 8, 1), (40, 1440, 1440, 8, 2), (37, 1536, 1536, 8, 2),
               (37, 1278, 1278, 8, 1), (37, 1290, 1290, 8, 2), (37, 130, 258, 8, 1)]


@pytest.mark.parametrize("r,h_in,h,ranks,fills", LSTM_SPLITS)
def test_lstm_cell_kernel_splits(dev, r, h_in, h, ranks, fills):
    """The split the kernel picks (clusters of ``ranks`` blocks, ``fills``
    of its ring a row tile) as tests/test_torch_lstm_split.py models it;
    h' and c' within 1e-5 of the twin and torch.lstm_cell, bit-equal when
    repeated."""
    got_split = [ctypes.c_int() for _ in range(3)]
    assert load_library().rs_lstm_split(h_in, h, *map(ctypes.byref, got_split)) == 0
    assert (got_split[0].value, got_split[2].value) == (ranks, fills)
    args = _lstm_inputs(r, h_in, h, seed=r * ranks + h)
    got = lstm_cell_step(*args, compute_dtype="float32")
    _check_lstm(got, args)
    again = lstm_cell_step(*args, compute_dtype="float32")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_lstm_cell_kernel_two_streams(dev):
    """Two streams at once, each with its own inputs: every result bit-equal
    to the same call made alone (no state is shared between calls), and
    within 1e-5 of the twin."""
    args = [_lstm_inputs(16, 640, 640, seed=s) for s in (1, 2)]
    alone = [lstm_cell_step(*a, compute_dtype="float32") for a in args]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(lstm_cell_step(*args[i], compute_dtype="float32"))
    torch.cuda.synchronize()
    for a, want, got in zip(args, alone, outs):
        _check_lstm(want, a)
        for g in got:
            assert all(torch.equal(x, y) for x, y in zip(want, g))


def test_step_kernels_refuse_bf16_and_bad_inputs(dev):
    """The decoders pass fp32 only: a bf16 compute dtype raises, as do
    inputs the kernels do not take; nothing falls back to the twin."""
    args = _joint_inputs(dev, 4, 256, 256, 2182, seed=0)
    with pytest.raises(ValueError, match="float32"):
        joint_topm(*args, 4, 0, activation="tanh", compute_dtype="bfloat16")
    with pytest.raises(ValueError):
        joint_topm(*args, 0, 0, activation="tanh", compute_dtype="float32")  # m < 1
    with pytest.raises(ValueError):
        topm_logsoftmax(args[4], 4, 256)  # blank past V
    with pytest.raises(TypeError):
        joint_topm(*args[:5], args[5].to(torch.bfloat16), 4, 0, activation="tanh",
                   compute_dtype="float32")
    x = args[5]
    w = torch.zeros(256, 1024, device=dev)
    with pytest.raises(ValueError, match="float32"):
        lstm_cell_step(w, w, w[0], x, x, x, compute_dtype="bfloat16")
    with pytest.raises(ValueError):
        lstm_cell_step(w, w, w[0], x, x[:, :128], x, compute_dtype="float32")  # h of H/2


def _to(tree, dev):
    """A nest of dicts, lists and tuples of tensors, on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.mark.parametrize("decoding", ["alsd", "graves"])
def test_tiny_decoders_run_the_step_kernels(dev, decoding):
    """ALSD and Graves with joint_impl/lstm_impl="pallas" on the card at a
    tiny width (pred_hidden 128): both step kernels launch, the top-m kernel
    does not, and the tokens equal those of the twins on the CPU."""
    from reazonspeech_tpu_torch.decoding import rnnt_beam, transducer_graves
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig, init_joint, init_predictor

    rnnt_cfg = RNNTConfig(vocab_size=200, enc_dim=64, pred_hidden=128, joint_hidden=64,
                          compute_dtype="float32", blank_position=(
                              "last" if decoding == "alsd" else "first"))
    gen = torch.Generator().manual_seed(0)
    params = (init_predictor(gen, rnnt_cfg), init_joint(gen, rnnt_cfg))
    enc = torch.randn((3, 20, 64), generator=gen)
    lens = torch.tensor([20, 13, 4])
    if decoding == "alsd":
        fn, cfg = rnnt_beam.rnnt_beam_decode, rnnt_beam.BeamDecodeConfig(
            beam_size=4, topk_impl="pallas", joint_impl="pallas", lstm_impl="pallas")
    else:
        fn, cfg = transducer_graves.graves_beam_decode, transducer_graves.GravesBeamConfig(
            beam_size=4, topk_impl="pallas", joint_impl="pallas", lstm_impl="pallas")
    reset_launch_counts()
    got = fn(*_to(params, dev), enc.to(dev), lens.to(dev), rnnt_cfg, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["joint_topm"] > 0 and counts["lstm_cell_step"] > 0, counts
    assert counts["topm_logsoftmax"] == 0
    want = fn(*params, enc, lens, rnnt_cfg, cfg)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
