"""The port's train step against the JAX package's on the same tree (the
bridge carries the encoder, predictor, joint, simple joint and CTC head)
and the same batch from numpy seeds, fp32, in the kernel configuration
(``attn_impl="pallas", lnd_impl="pallas", conv_impl="xla"``; the JAX
kernels in interpret mode, the port's wrappers over their twins): the loss
and every leaf's gradient, the batch-norm statistics included, and one
AdamW update (new minus old params), each to relative L2 1e-3; the pruned
and CTC objectives; ``remat`` gradients equal to no-``remat``; the refusal
of a ``pipeline=`` schedule that does not fit."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.frontend.features import nemo_frontend_config as j_fe
from reazonspeech_tpu.models import conformer as jconf
from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
from reazonspeech_tpu.ops.testing import patch_interpret
from reazonspeech_tpu.training import pruned_rnnt as jp
from reazonspeech_tpu.training import train_step as jts
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.frontend.features import nemo_frontend_config as t_fe
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt
from reazonspeech_tpu_torch.training import train_step as tts

from test_torch_parity import jax_params_numpy, randomize_norm_stats

# the kernel configuration of training; 8 heads of dh=16 take the packed
# attention route (rows 4-7), 4 heads of dh=16 the [B, H, T, dh] one (row 8)
KERNELS = dict(compute_dtype="float32", attn_impl="pallas", lnd_impl="pallas", conv_impl="xla")
ROUTES = {"packed": dict(d_model=128, num_heads=8), "generic": dict(d_model=64, num_heads=4)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _configs(route):
    jenc = JEnc.tiny(**ROUTES[route], **KERNELS)
    tenc = TEnc.tiny(**ROUTES[route], **KERNELS)
    d = jenc.d_model
    return (jenc, JRnnt.tiny(enc_dim=d, compute_dtype="float32"), tenc,
            TRnnt.tiny(enc_dim=d, compute_dtype="float32"))


def _tree(jenc, jr, seed=0):
    """init_params plus the simple joint and the CTC head, with non-trivial
    batch-norm statistics and LayerNorm affines."""
    tree = randomize_norm_stats(jax_params_numpy(seed, jenc, jr), seed=seed + 1)
    tree["simple_joint"] = jax.tree.map(
        np.asarray, jp.init_simple_joint(jax.random.PRNGKey(seed + 2), jr))
    tree["ctc"] = jax.tree.map(np.asarray, jconf.init_ctc_head(
        jax.random.PRNGKey(seed + 3), jenc.d_model, jr.vocab_size))
    return tree


def _batch(seed=0, b=3, u=5, vocab=64):
    rng = np.random.default_rng(seed)
    n = 16000
    lengths = np.array([n, 12000, 8000][:b], np.int32)
    wav = np.zeros((b, n), np.float32)
    for i, m in enumerate(lengths):
        wav[i, :m] = rng.standard_normal(m) * 0.1
    labels = rng.integers(1, vocab, (b, u)).astype(np.int32)
    return {"waveform": wav, "lengths": lengths, "labels": labels,
            "label_lengths": np.array([u, 3, 2][:b], np.int32)}


def _flat(tree, prefix=""):
    """{path: leaf} in jax.tree.leaves order (sorted keys)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _unflat(flat, like, prefix=""):
    """The inverse of _flat on the structure of ``like``."""
    if isinstance(like, dict):
        return {k: _unflat(flat, v, f"{prefix}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflat(flat, v, f"{prefix}/{i}") for i, v in enumerate(like)]
    return flat[prefix]


def _jax_loss_and_grads(monkeypatch, jenc, jr, tree, batch, **kw):
    patch_interpret(monkeypatch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jts.compute_loss(p, jbatch, j_fe(), jenc, jr, **kw)

    val, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, tree))
    return float(val), _flat(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(tenc, tr, tree, batch, **kw):
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), tree)
    leaves = _flat(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    val = tts.compute_loss(params, tb, t_fe(), tenc, tr, **kw)
    grads = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
    return float(val.detach()), {k: (np.zeros(x.shape, np.float32) if g is None else g.numpy())
                        for (k, x), g in zip(leaves.items(), grads)}


def _check_grads(got, want, tol=1e-3):
    assert got.keys() == want.keys()
    flat_g = np.concatenate([got[k].ravel() for k in want])
    flat_w = np.concatenate([np.asarray(want[k]).ravel() for k in want])
    assert _rel(flat_g, flat_w) <= tol
    for k in want:
        if np.linalg.norm(want[k]) > 1e-6 * np.linalg.norm(flat_w):
            assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))
        else:  # a leaf the loss does not reach (the unused heads): zero in both
            assert np.abs(got[k]).max() <= 1e-6 * np.linalg.norm(flat_w), k


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_full_loss_and_grads_match_jax(monkeypatch, route):
    """loss="full": the value and every leaf's gradient, the conv module's
    batch-norm mean and var included (the JAX step differentiates the whole
    tree)."""
    jenc, jr, tenc, tr = _configs(route)
    tree, batch = _tree(jenc, jr), _batch()
    want_v, want_g = _jax_loss_and_grads(monkeypatch, jenc, jr, tree, batch)
    got_v, got_g = _port_loss_and_grads(tenc, tr, tree, batch)
    assert abs(got_v - want_v) <= 1e-3 * abs(want_v)
    _check_grads(got_g, want_g)
    for stat in ("mean", "var"):
        key = f"/encoder/blocks/conv_bn/{stat}"
        assert np.linalg.norm(want_g[key]) > 0 and np.linalg.norm(got_g[key]) > 0


@pytest.mark.parametrize("kw", [dict(loss="pruned", s_range=3), dict(ctc_weight=0.3)],
                         ids=["pruned", "ctc"])
def test_other_objectives_match_jax(monkeypatch, kw):
    jenc, jr, tenc, tr = _configs("packed")
    tree, batch = _tree(jenc, jr, seed=4), _batch(seed=5)
    want_v, want_g = _jax_loss_and_grads(monkeypatch, jenc, jr, tree, batch, **kw)
    got_v, got_g = _port_loss_and_grads(tenc, tr, tree, batch, **kw)
    assert abs(got_v - want_v) <= 1e-3 * abs(want_v)
    _check_grads(got_g, want_g)


def test_train_step_update_matches_jax(monkeypatch):
    """One make_train_step step (the default AdamW, lr 1e-4, weight decay
    0.01, against optax.adamw): the loss and grad-norm metrics, and the
    update (new minus old params) to relative L2 1e-3, the whole tree's and
    each leaf's, over the elements whose JAX gradient stands clear of fp32
    rounding (|g| > 1e-7·max|g|). Adam's first update is lr·g/(|g|+1e-8),
    about lr·sign(g): where g is rounding noise (the key bias's, zero in
    exact arithmetic since a per-row constant leaves the softmax unchanged,
    is ~3e-9 against a largest gradient of ~13) its sign is noise, and those
    elements are held to Adam's bound |update| <= lr + lr·wd·|p|. A leaf the
    loss does not reach (the unused simple joint and CTC head) moves by
    weight decay alone, ~1e-6·p, a few units in p's last place: two units."""
    import optax

    jenc, jr, tenc, tr = _configs("packed")
    tree, batch = _tree(jenc, jr, seed=6), _batch(seed=7)
    # the body of the JAX train_step with its default optimizer, on the
    # gradients of its compute_loss (one compile instead of two)
    loss, grads = _jax_loss_and_grads(monkeypatch, jenc, jr, tree, batch)
    opt = optax.adamw(1e-4, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, tree)
    jgrads = jax.tree.map(jnp.asarray, _unflat(grads, tree))
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    new = jax.tree.map(np.asarray, optax.apply_updates(jparams, updates))
    leaves = _flat(tree)
    want = {k: v - leaves[k] for k, v in _flat(new).items()}
    t_init, t_step = tts.make_train_step(t_fe(), tenc, tr)
    tstate, tm = t_step(t_init(params_from_numpy(tree)), batch)
    assert tstate.step == 1
    got = {k: v.detach().numpy() - leaves[k] for k, v in _flat(tstate.params).items()}
    np.testing.assert_allclose(float(tm["loss"]), loss, rtol=1e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(optax.global_norm(jgrads)),
                               rtol=1e-3)
    assert got.keys() == want.keys() == grads.keys()
    gmax = max(np.abs(g).max() for g in grads.values())
    solid = {k: np.abs(grads[k]) > 1e-7 * gmax for k in want}
    assert _rel(np.concatenate([got[k][solid[k]] for k in want]),
                np.concatenate([want[k][solid[k]] for k in want])) <= 1e-3
    for k in want:
        if k.startswith(("/simple_joint/", "/ctc/")):
            assert np.abs(got[k] - want[k]).max() <= 2 * np.spacing(np.abs(leaves[k]).max()), k
            continue
        if solid[k].any():
            assert _rel(got[k][solid[k]], want[k][solid[k]]) <= 1e-3, k
        bound = 1e-4 * (1 + 0.01 * np.abs(leaves[k])) + np.spacing(np.abs(leaves[k]))
        assert (np.abs(got[k]) <= bound)[~solid[k]].all(), k


def test_remat_gradients_equal_no_remat():
    """remat=True (each block recomputed in the backward through
    torch.utils.checkpoint, the wrappers' kernels run again) gives the
    gradients of remat=False."""
    jenc, jr, tenc, tr = _configs("packed")
    tree, batch = _tree(jenc, jr, seed=8), _batch(seed=9)
    v0, g0 = _port_loss_and_grads(tenc, tr, tree, batch)
    v1, g1 = _port_loss_and_grads(replace(tenc, remat=True), tr, tree, batch)
    assert v0 == v1
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-9)


def test_bridge_carries_the_training_heads():
    """The weight bridge carries every entry of the training tree: the JAX
    and port steps start from the same leaves."""
    jenc, jr, _, _ = _configs("generic")
    tree = _tree(jenc, jr)
    got = _flat(params_from_numpy(tree))
    want = _flat(tree)
    assert got.keys() == want.keys()
    assert any(k.startswith("/simple_joint/") for k in got)
    assert any(k.startswith("/ctc/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_pipeline_is_refused():
    """pipeline= runs (tests/test_torch_parallel_pipeline.py); a schedule
    that does not fit the encoder (2 blocks over 3 stages) is refused by the
    step with the reference's message."""
    from reazonspeech_tpu_torch.parallel.pipeline import PipelineSpec, make_pipeline_mesh

    _, _, tenc, tr = _configs("generic")
    spec = PipelineSpec(mesh=make_pipeline_mesh(3, devices=["cpu"] * 3))
    init_state, step = tts.make_train_step(t_fe(), tenc, tr, pipeline=spec)
    tree = params_from_numpy(_tree(*_configs("generic")[:2]))
    with pytest.raises(ValueError, match="must divide by the 'pipe' axis size"):
        step(init_state(tree), _batch())
