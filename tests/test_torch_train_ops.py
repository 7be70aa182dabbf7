"""The six differentiable kernel wrappers of the port (the kernel forward,
the plain twin's backward) against the JAX package's custom-VJP
``*_diff`` functions, whose Pallas forwards run in interpret mode as the
JAX kernel tests run them: the same inputs from numpy seeds at fp32, the
forward to 1e-5 and every input's gradient to relative L2 1e-4. Then the
refusals: a kernel entry with no backward raises when autograd records on
an input (meta tensors stand in for CUDA ones, so the CUDA branch is taken
with no card), and ``conv_impl="pallas"`` under autograd raises in both
packages."""

import importlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.ops import ln_dense as jlnd
from reazonspeech_tpu.ops import relpos_attention as jra
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu_torch.ops import beam_topk, conformer_conv, lstm_step
from reazonspeech_tpu_torch.ops import relpos_attention as tra
from reazonspeech_tpu_torch.ops import zipformer_attention as tza

# the module (ops/__init__.py re-exports its function ln_dense under that name)
tlnd = importlib.import_module("reazonspeech_tpu_torch.ops.ln_dense")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _mk(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _compare(jfn, tfn, arrays, diff_idx, out_weights_seed=0):
    """Forward and gradients of ``Σ w·out`` (fixed random weights per
    output) by the arrays at ``diff_idx``, JAX against the port."""
    rng = np.random.default_rng(out_weights_seed)
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    weights = [_mk(rng, *np.shape(o)) for o in jouts]

    def jloss(*diff):
        args = [jnp.asarray(a) for a in arrays]
        for i, x in zip(diff_idx, diff):
            args[i] = x
        out = jfn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * w) for o, w in zip(outs, weights))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(diff_idx))))(
        *[jnp.asarray(arrays[i]) for i in diff_idx])
    targs = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in diff_idx:
        targs[i].requires_grad_(True)
    tout = tfn(*targs)
    touts = tout if isinstance(tout, tuple) else (tout,)
    assert len(touts) == len(jouts)
    for o, j in zip(touts, jouts):
        assert o.grad_fn is not None
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    loss = sum((o.float() * torch.from_numpy(w)).sum() for o, w in zip(touts, weights))
    tgrads = torch.autograd.grad(loss, [targs[i] for i in diff_idx])
    for i, g, j in zip(diff_idx, tgrads, jgrads):
        assert _rel(g.numpy(), j) <= 1e-4, (i, _rel(g.numpy(), j))


def _ln_inputs(seed, b=2, t=40, d=128, n=(128,)):
    rng = np.random.default_rng(seed)
    x = _mk(rng, b, t, d, scale=2.0) + _mk(rng, b, t, 1)
    g = 1.0 + _mk(rng, d, scale=0.1)
    bb = _mk(rng, d, scale=0.1)
    ws = [_mk(rng, d, ni, scale=1 / np.sqrt(d)) for ni in n]
    cs = [_mk(rng, ni, scale=0.1) for ni in n]
    return x, g, bb, ws, cs


@pytest.mark.parametrize("activation", [None, "swish"])
def test_ln_dense_diff_matches_jax(monkeypatch, activation):
    patch_interpret(monkeypatch)
    x, g, bb, (w,), (c,) = _ln_inputs(1)
    _compare(lambda *a: jlnd.ln_dense_diff(*a, activation, None),
             lambda *a: tlnd.ln_dense_diff(*a, activation=activation),
             [x, g, bb, w, c], [0, 1, 2, 3, 4])


def test_ln_dense_diff_segments_match_jax(monkeypatch):
    """The packed q/k/v form: three weight segments and biases."""
    patch_interpret(monkeypatch)
    x, g, bb, ws, cs = _ln_inputs(2, d=64, n=(64, 64, 64))
    _compare(lambda x, g, b, *wc: jlnd.ln_dense_diff(x, g, b, tuple(wc[:3]), tuple(wc[3:]),
                                                     None, None),
             lambda x, g, b, *wc: tlnd.ln_dense_diff(x, g, b, wc[:3], wc[3:]),
             [x, g, bb, *ws, *cs], list(range(9)))


def test_ln_dense_add_diff_matches_jax(monkeypatch):
    """Two outputs, the projection and the summed stream, both differentiated."""
    patch_interpret(monkeypatch)
    x, g, bb, ws, cs = _ln_inputs(3, d=64, n=(64, 64, 64))
    delta = _mk(np.random.default_rng(4), *x.shape)
    _compare(lambda r, dl, g, b, *wc: jlnd.ln_dense_add_diff(
                 r, dl, g, b, tuple(wc[:3]), tuple(wc[3:]), 0.5, None, None, 1e-5),
             lambda r, dl, g, b, *wc: tlnd.ln_dense_add_diff(r, dl, g, b, wc[:3], wc[3:],
                                                             scale=0.5),
             [x, delta, g, bb, *ws, *cs], list(range(10)))


def test_add_ln_diff_matches_jax(monkeypatch):
    patch_interpret(monkeypatch)
    rng = np.random.default_rng(5)
    r, y = _mk(rng, 3, 40, 128, scale=2.0), _mk(rng, 3, 40, 128)
    g, bb = 1.0 + _mk(rng, 128, scale=0.1), _mk(rng, 128, scale=0.1)
    lens = np.array([40, 23, 7], np.int32)
    _compare(lambda r, y, l, g, b: jlnd.add_ln_diff(r, y, l, g, b, 0.5, 1e-5, None),
             lambda r, y, l, g, b: tlnd.add_ln_diff(r, y, l, g, b, scale=0.5),
             [r, y, lens, g, bb], [0, 1, 3, 4])


def _fused_inputs(seed, b=2, h=2, t=24, dh=8):
    rng = np.random.default_rng(seed)
    d = h * dh
    return ([_mk(rng, b, t, d) for _ in range(3)] + [_mk(rng, 2 * t - 1, h, dh)]
            + [_mk(rng, h, dh, scale=0.3) for _ in range(2)] + [np.array([t, t - 7], np.int32)])


def test_relpos_attention_fused_packed_diff_matches_jax(monkeypatch):
    """Gradients for the packed qkv, the position table and both biases."""
    patch_interpret(monkeypatch)
    q, k, v, pos, bu, bv, lens = _fused_inputs(6)
    qkv = np.concatenate([q, k, v], axis=-1)
    _compare(lambda *a: jra.relpos_attention_fused_packed_diff(*a, 2),
             lambda *a: tra.relpos_attention_fused_packed_diff(*a, 2),
             [qkv, pos, bu, bv, lens], [0, 1, 2, 3])


def test_relpos_attention_fused_diff_matches_jax(monkeypatch):
    patch_interpret(monkeypatch)
    _compare(lambda *a: jra.relpos_attention_fused_diff(*a, 2),
             lambda *a: tra.relpos_attention_fused_diff(*a, 2),
             _fused_inputs(7), [0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize("t", [24, 1030])
def test_relpos_attention_diff_matches_jax(monkeypatch, t):
    """[B, H, T, dh]: the single-pass forward at T=24, the streamed one past
    T = 1024 (the backward is the single-pass formula's at every T)."""
    patch_interpret(monkeypatch)
    rng = np.random.default_rng(8)
    b, h, dh = 1, 2, 8
    arrays = [_mk(rng, b, h, t, dh) for _ in range(4)] + [_mk(rng, 2 * t - 1, h, dh),
                                                         np.array([t - 5], np.int32)]
    _compare(jra.relpos_attention_diff, tra.relpos_attention_diff, arrays, [0, 1, 2, 3, 4])


def test_wrapper_backward_is_the_twins():
    """On the CPU the wrapper's forward is the twin, and its gradients are
    the twin's own autograd gradients, bit for bit (the same ops)."""
    x, g, bb, (w,), (c,) = _ln_inputs(9, d=32, n=(48,))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, bb, w, c)]
    out = tlnd.ln_dense_diff(*leaves, activation="swish")
    got = torch.autograd.grad(out.square().sum(), leaves)
    want = torch.autograd.grad(
        tlnd.ln_dense_plain(*leaves, activation="swish").square().sum(), leaves)
    for a, e in zip(got, want):
        assert torch.equal(a, e)


# --- refusals ------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def _no_backward_calls():
    """Each kernel entry of the port with no differentiable wrapper (rows 2,
    3 and 10-13), and each one whose wrapper is the way to train it (rows
    1, 4-9), on meta tensors that require grad."""
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    bf = torch.bfloat16
    return {
        "fused_conv_module": lambda: conformer_conv.fused_conv_module(
            _meta(2, 8, 16), lens, _meta(16, 32), _meta(32), _meta(3, 16), _meta(16),
            _meta(16), _meta(16), _meta(16, 16), _meta(16)),
        "topm_logsoftmax": lambda: beam_topk.topm_logsoftmax(_meta(4, 32, dtype=torch.float32),
                                                             4, 0),
        "joint_topm": lambda: beam_topk.joint_topm(
            _meta(8, 16, dtype=torch.float32), _meta(16, dtype=torch.float32),
            _meta(16, 32, dtype=torch.float32), _meta(32, dtype=torch.float32),
            _meta(4, 16, dtype=torch.float32), _meta(4, 8, dtype=torch.float32), 4, 0,
            compute_dtype="float32"),
        "lstm_cell_step": lambda: lstm_step.lstm_cell_step(
            _meta(8, 32, dtype=torch.float32), _meta(8, 32, dtype=torch.float32),
            _meta(32, dtype=torch.float32), _meta(4, 8, dtype=torch.float32),
            _meta(4, 8, dtype=torch.float32), _meta(4, 8, dtype=torch.float32),
            compute_dtype="float32"),
        "shared_rel_attention": lambda: tza.shared_rel_attention(
            _meta(2, 8, 16), _meta(2, 8, 16), _meta(2, 8, 4), _meta(1, 15, 4), _meta(2, 8, 8),
            lens),
        "shared_rel_attention_blockwise": lambda: tza.shared_rel_attention_blockwise(
            _meta(2, 8, 16), _meta(2, 8, 16), _meta(2, 8, 4), _meta(1, 15, 4), _meta(2, 8, 8),
            lens),
        "ln_dense": lambda: tlnd.ln_dense(_meta(2, 8, 16, dtype=torch.float32),
                                          _meta(16, dtype=torch.float32),
                                          _meta(16, dtype=torch.float32), _meta(16, 16)),
        "ln_dense_add": lambda: tlnd.ln_dense_add(
            _meta(2, 8, 16, dtype=torch.float32), _meta(2, 8, 16),
            _meta(16, dtype=torch.float32), _meta(16, dtype=torch.float32), _meta(16, 16)),
        "add_ln": lambda: tlnd.add_ln(_meta(2, 8, 16, dtype=torch.float32), _meta(2, 8, 16),
                                      lens, _meta(16, dtype=torch.float32),
                                      _meta(16, dtype=torch.float32)),
        "relpos_attention_fused": lambda: tra.relpos_attention_fused(
            _meta(2, 8, 16), _meta(2, 8, 16), _meta(2, 8, 16), _meta(15, 2, 8),
            _meta(2, 8, dtype=bf), _meta(2, 8, dtype=bf), lens, 2),
        "relpos_attention_fused_packed": lambda: tra.relpos_attention_fused_packed(
            _meta(2, 8, 48), _meta(15, 2, 8), _meta(2, 8), _meta(2, 8), lens, 2),
        "relpos_attention": lambda: tra.relpos_attention(
            _meta(2, 2, 8, 8), _meta(2, 2, 8, 8), _meta(2, 2, 8, 8), _meta(2, 2, 8, 8),
            _meta(15, 2, 8), lens),
        "relpos_attention_blockwise": lambda: tra.relpos_attention_blockwise(
            _meta(2, 2, 8, 8), _meta(2, 2, 8, 8), _meta(2, 2, 8, 8), _meta(2, 2, 8, 8),
            _meta(15, 2, 8), lens),
    }


@pytest.mark.parametrize("kernel", sorted(_no_backward_calls()))
def test_kernel_entry_refuses_autograd(kernel):
    """A ctypes launch records no grad_fn: where autograd records, the entry
    raises instead of returning silently zero gradients; in no-grad mode
    the same call goes on to the CUDA checks (which refuse a meta tensor
    with another error)."""
    call = _no_backward_calls()[kernel]
    with pytest.raises(NotImplementedError, match=kernel):
        call()
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        call()


def test_conv_kernel_refuses_autograd_on_the_cpu():
    """As JAX (fused_conv_module has no VJP), the conv kernel refuses to be
    differentiated on every device, its CPU twin included."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_mk(rng, 2, 8, 16)).requires_grad_(True)
    args = [torch.from_numpy(_mk(rng, *s)) for s in
            ((16, 32), (32,), (3, 16), (16,), (16,), (16,), (16, 16), (16,))]
    lens = torch.tensor([8, 5], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="fused_conv_module"):
        conformer_conv.fused_conv_module(x, lens, *args)
    with torch.no_grad():
        conformer_conv.fused_conv_module(x, lens, *args)


def test_encoder_conv_pallas_under_autograd_raises_in_both():
    """conv_impl="pallas" under autograd: JAX's jax.grad raises
    NotImplementedError, and so does the port's backward-recording
    forward; conv_impl="xla" trains in both."""
    from reazonspeech_tpu.models import fastconformer as jfc
    from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
    from reazonspeech_tpu_torch.models import fastconformer as tfc

    jcfg = jfc.FastConformerConfig.tiny(compute_dtype="float32", attn_impl="pallas",
                                        lnd_impl="pallas", conv_impl="pallas")
    tcfg = tfc.FastConformerConfig.tiny(compute_dtype="float32", attn_impl="pallas",
                                        lnd_impl="pallas", conv_impl="pallas")
    tree = jax.tree.map(np.asarray, jfc.init_fastconformer(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)
    feats = _mk(rng, 2, 64, jcfg.feat_in)
    lens = np.array([64, 40], np.int32)

    def jloss(p, cfg):
        enc, _ = jfc.fastconformer_encode(p, jnp.asarray(feats), jnp.asarray(lens), cfg)
        return jnp.sum(enc)

    with pytest.raises(NotImplementedError):
        jax.grad(jloss)(jax.tree.map(jnp.asarray, tree), jcfg)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), tree)
    with pytest.raises(NotImplementedError, match="fused_conv_module"):
        tfc.fastconformer_encode(params, torch.from_numpy(feats), torch.from_numpy(lens), tcfg)
    enc, _ = tfc.fastconformer_encode(params, torch.from_numpy(feats), torch.from_numpy(lens),
                                      replace(tcfg, conv_impl="xla"))
    assert enc.grad_fn is not None
