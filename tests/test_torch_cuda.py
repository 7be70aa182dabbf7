"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where no GPU is present. On a machine with one
(and without JAX, which ``tests/conftest.py`` imports) run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch.ops import (
    add_ln, add_ln_plain, fused_conv_module, fused_conv_module_plain, launch_counts, ln_dense,
    ln_dense_add, ln_dense_add_plain, ln_dense_plain, relpos_attention_fused,
    relpos_attention_fused_packed, relpos_attention_fused_packed_plain,
    relpos_attention_fused_plain, reset_launch_counts, shared_rel_attention,
    shared_rel_attention_blockwise, shared_rel_attention_blockwise_plain,
    shared_rel_attention_plain, topm_logsoftmax, topm_logsoftmax_plain,
)
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


def _bf16_tol(want):
    """2 bf16 ulps at the largest |value| (the kernel and the twin round at
    the same points; only their fp32 sums differ in order)."""
    return 2.0 * 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)


def _max_err(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    return (got.float() - want.float()).abs().max().item()


# the serving shapes (B=4, T=401, D=1024) and an odd one (T=33, D=128)
LN_SHAPES = [(401, 1024, (4096,), "swish"), (401, 1024, (1024,) * 3, None),
             (33, 128, (512,), "swish"), (33, 128, (128,) * 3, None)]


def _ln_inputs(dev, t, d, widths, seed):
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    x = _rand(gen, 4, t, d, dtype=f32) + 0.5
    g, b = 1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32)
    ws = tuple(_rand(gen, d, n, scale=0.5 * d ** -0.5) for n in widths)
    cs = tuple(_rand(gen, n, scale=0.1, dtype=f32) for n in widths)
    return gen, x, g, b, (ws if len(ws) > 1 else ws[0]), (cs if len(cs) > 1 else cs[0])


@pytest.mark.parametrize("t,d,widths,act", LN_SHAPES)
def test_ln_dense_kernel_matches_plain(dev, t, d, widths, act):
    """bf16 out within 2 bf16 ulps of the twin at the largest |value|."""
    _, x, g, b, w, c = _ln_inputs(dev, t, d, widths, seed=t + d)
    got = ln_dense(x, g, b, w, c, activation=act)
    want = ln_dense_plain(x, g, b, w, c, act)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= _bf16_tol(want)


@pytest.mark.parametrize("t,d,widths,act", LN_SHAPES)
def test_ln_dense_add_kernel_matches_plain(dev, t, d, widths, act):
    """The projection as ln_dense; the fp32 stream r + 0.5·delta to 1e-5."""
    gen, x, g, b, w, c = _ln_inputs(dev, t, d, widths, seed=t * d)
    delta = _rand(gen, 4, t, d)
    got, got_x = ln_dense_add(x, delta, g, b, w, c, scale=0.5, activation=act)
    want, want_x = ln_dense_add_plain(x, delta, g, b, w, c, 0.5, act)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= _bf16_tol(want)
    assert _max_err(got_x, want_x) <= 1e-5


@pytest.mark.parametrize("t,d", [(401, 1024), (33, 128)])
def test_add_ln_kernel_matches_plain(dev, t, d):
    """fp32 out to 1e-4 (the statistics summed in another order); rows at
    or past each length exactly zero."""
    gen, x, g, b, _, _ = _ln_inputs(dev, t, d, (64,), seed=t)
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
    _, x, g, b, w, c = _ln_inputs(dev, 33, 128, (128,), seed=0)
    with pytest.raises(TypeError):
        ln_dense(x, g, b, w.float(), c)  # fp32 weights
    with pytest.raises(ValueError):
        ln_dense(x, g, b, w[:, :96].contiguous(), c[:96])  # width not a multiple of 64
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


def test_shared_attention_wrong_inputs_raise(dev):
    args = list(_shared_inputs(dev, 2, 33, 32, 12, 1, seed=0))
    with pytest.raises(TypeError):
        shared_rel_attention(*([args[0].float()] + args[1:]))  # fp32 q
    with pytest.raises(ValueError):
        shared_rel_attention(*(args[:3] + [args[3][:, :10]] + args[4:]))  # short pos table
    with pytest.raises(ValueError):
        shared_rel_attention_blockwise(*(args[:4] + [args[4][:, :, :5]] + args[5:]))  # not contiguous
    wide = list(_shared_inputs(dev, 2, 33, 64, 12, 1, seed=0))
    with pytest.raises(ValueError):
        shared_rel_attention(*wide)  # qd=64: the kernel takes qd <= 32


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
    with pytest.raises(ValueError):
        relpos_attention(*(x[..., :8] for x in (qu, qv, k, v)), pos[..., :8], lengths)  # dh=8


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
