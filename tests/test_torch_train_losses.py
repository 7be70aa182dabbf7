"""The port's training losses against the JAX package's on the same inputs
(numpy seeds, fp32): the RNN-T wavefront, optax's CTC, and the pruned
family (the simple loss, the prune ranges as integers, the pruned loss and
the bundle), each value to relative 1e-5 and each gradient to relative L2
1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
from reazonspeech_tpu.training import losses as jl
from reazonspeech_tpu.training import pruned_rnnt as jp
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt
from reazonspeech_tpu_torch.training import losses as tl
from reazonspeech_tpu_torch.training import pruned_rnnt as tp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _lattice(seed, b=3, t=9, u=5, k=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, u + 1, k)).astype(np.float32)
    labels = rng.integers(1, k, (b, u)).astype(np.int32)
    t_len = np.array([t, t - 3, 4][:b], np.int32)
    u_len = np.array([u, 2, 0][:b], np.int32)
    return logits, labels, t_len, u_len


@pytest.mark.parametrize("blank", [0, 6])
def test_rnnt_loss_matches_jax(blank):
    logits, labels, t_len, u_len = _lattice(1)
    args = (jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(u_len), blank)
    want = jl.rnnt_loss(jnp.asarray(logits), *args)
    want_g = jax.grad(lambda x: jnp.sum(jl.rnnt_loss(x, *args) * jnp.arange(1.0, 4.0)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tl.rnnt_loss(x, torch.from_numpy(t_len), torch.from_numpy(labels),
                       torch.from_numpy(u_len), blank)
    (got_g,) = torch.autograd.grad((got * torch.arange(1.0, 4.0)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert _rel(got_g.numpy(), want_g) <= 1e-4


def test_rnnt_loss_without_labels_matches_jax():
    """U = 0: the lattice is one column of blanks."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 1, 4)).astype(np.float32)
    t_len, labels, u_len = np.array([6, 3], np.int32), np.zeros((2, 0), np.int32), \
        np.zeros(2, np.int32)
    want = jl.rnnt_loss(jnp.asarray(logits), jnp.asarray(t_len), jnp.asarray(labels),
                        jnp.asarray(u_len), 0)
    got = tl.rnnt_loss(torch.from_numpy(logits), torch.from_numpy(t_len),
                       torch.from_numpy(labels), torch.from_numpy(u_len), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("case", ["feasible", "repeats", "infeasible"])
def test_ctc_loss_matches_optax(case):
    """optax's value and gradient, its large finite value included where the
    labels cannot fit the frames (F.ctc_loss gives inf there). An infeasible
    row's gradient comes from differences of fp32 numbers near
    ``log_epsilon`` (-1e5, a unit in the last place ~0.008), where two
    orders of the same operations part at ~1e-3: that row is held to finite
    values within relative L2 1e-2; the feasible rows to 1e-4."""
    rng = np.random.default_rng(2)
    b, t, k, n = 3, 12, 6, 5
    logits = rng.standard_normal((b, t, k)).astype(np.float32)
    labels = rng.integers(1, k, (b, n)).astype(np.int32)
    t_len = np.array([12, 9, 6], np.int32)
    n_len = np.array([5, 3, 1], np.int32)
    if case == "repeats":
        labels[:, 1] = labels[:, 0]
    if case == "infeasible":
        t_len = np.array([12, 2, 6], np.int32)  # row 1: 3 labels in 2 frames
    args = (jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(n_len), 0)
    want = jl.ctc_loss(jnp.asarray(logits), *args)
    want_g = jax.grad(lambda x: jnp.sum(jl.ctc_loss(x, *args)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tl.ctc_loss(x, torch.from_numpy(t_len), torch.from_numpy(labels),
                      torch.from_numpy(n_len), 0)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    feasible = [0, 2] if case == "infeasible" else [0, 1, 2]
    assert _rel(got_g.numpy()[feasible], np.asarray(want_g)[feasible]) <= 1e-4
    if case == "infeasible":
        assert np.isfinite(got_g.numpy()).all()
        assert _rel(got_g.numpy()[1], np.asarray(want_g)[1]) <= 1e-2


def _simple_inputs(seed, b=3, t=11, u=6, v=9):
    rng = np.random.default_rng(seed)
    am = rng.standard_normal((b, t, v)).astype(np.float32) * 2
    lm = rng.standard_normal((b, u + 1, v)).astype(np.float32) * 2
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    t_len = np.array([t, 8, 5][:b], np.int32)
    u_len = np.array([u, 4, 1][:b], np.int32)
    return am, lm, labels, t_len, u_len


def test_simple_loss_matches_jax():
    am, lm, labels, t_len, u_len = _simple_inputs(3)
    jargs = (jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(u_len), 0)
    want = jp.rnnt_loss_simple(jnp.asarray(am), jnp.asarray(lm), *jargs)
    wa, wl = jax.grad(lambda a, b_: jnp.sum(jp.rnnt_loss_simple(a, b_, *jargs)),
                      argnums=(0, 1))(jnp.asarray(am), jnp.asarray(lm))
    a = torch.from_numpy(am).requires_grad_(True)
    m = torch.from_numpy(lm).requires_grad_(True)
    got = tp.rnnt_loss_simple(a, m, torch.from_numpy(t_len), torch.from_numpy(labels),
                              torch.from_numpy(u_len), 0)
    ga, gl = torch.autograd.grad(got.sum(), (a, m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert _rel(ga.numpy(), wa) <= 1e-4 and _rel(gl.numpy(), wl) <= 1e-4


@pytest.mark.parametrize("s_range", [2, 3, 5, 7])
def test_prune_ranges_match_jax(s_range):
    """The window starts as integers, through the occupancies' argmax and the
    monotone projections, at band widths below, at and past U+1."""
    am, lm, labels, t_len, u_len = _simple_inputs(4)
    want = jp.prune_ranges(jnp.asarray(am), jnp.asarray(lm), jnp.asarray(t_len),
                           jnp.asarray(labels), jnp.asarray(u_len), 0, s_range)
    got = tp.prune_ranges(torch.from_numpy(am), torch.from_numpy(lm), torch.from_numpy(t_len),
                          torch.from_numpy(labels), torch.from_numpy(u_len), 0, s_range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_monotone_band_ties_and_ramps():
    """_monotone_band on raw starts with decreases, jumps and a short row."""
    start = np.array([[0, 3, 1, 5, 5, 2], [2, 2, 0, 0, 4, 4]], np.int32)
    t_len, u_len = np.array([6, 3], np.int32), np.array([5, 4], np.int32)
    want = jp._monotone_band(jnp.asarray(start), 3, jnp.asarray(t_len), jnp.asarray(u_len), 6)
    got = tp._monotone_band(torch.from_numpy(start), 3, torch.from_numpy(t_len),
                            torch.from_numpy(u_len), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _joint_inputs(seed, b=3, t=8, u=5, e=12, h=10, j=16, vocab=9):
    rng = np.random.default_rng(seed)
    jcfg = JRnnt(vocab_size=vocab, enc_dim=e, pred_hidden=h, joint_hidden=j,
                 compute_dtype="float32")
    tcfg = TRnnt(vocab_size=vocab, enc_dim=e, pred_hidden=h, joint_hidden=j,
                 compute_dtype="float32")
    from reazonspeech_tpu.models.rnnt import init_joint

    joint = jax.tree.map(np.asarray, init_joint(jax.random.PRNGKey(seed), jcfg))
    simple = jax.tree.map(np.asarray, jp.init_simple_joint(jax.random.PRNGKey(seed + 1), jcfg))
    enc = rng.standard_normal((b, t, e)).astype(np.float32)
    pred = rng.standard_normal((b, u + 1, h)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, u)).astype(np.int32)
    t_len = np.array([t, 6, 3][:b], np.int32)
    u_len = np.array([u, 3, 1][:b], np.int32)
    return jcfg, tcfg, joint, simple, enc, pred, labels, t_len, u_len


@pytest.mark.parametrize("s_range", [3, 6])
def test_pruned_loss_matches_jax(s_range):
    """rnnt_loss_pruned on the JAX ranges: value and the gradients of the
    joint's leaves, enc and pred; at s_range = U+1 it is the full loss."""
    jcfg, tcfg, joint, _, enc, pred, labels, t_len, u_len = _joint_inputs(6)
    rng = np.random.default_rng(7)
    ranges = np.asarray(jp._monotone_band(
        jnp.asarray(rng.integers(0, 4, (3, 8)).astype(np.int32)), s_range,
        jnp.asarray(t_len), jnp.asarray(u_len), 5))

    def jloss(jt, e, p):
        return jnp.sum(jp.rnnt_loss_pruned(jt, e, p, jnp.asarray(ranges), jnp.asarray(labels),
                                           jnp.asarray(t_len), jnp.asarray(u_len), jcfg,
                                           s_range))

    jtree = jax.tree.map(jnp.asarray, joint)
    want = jloss(jtree, jnp.asarray(enc), jnp.asarray(pred))
    wj, we, wp = jax.grad(jloss, argnums=(0, 1, 2))(jtree, jnp.asarray(enc), jnp.asarray(pred))
    tj = {k: {n: x.requires_grad_(True) for n, x in v.items()}
          for k, v in params_from_numpy(joint).items()}
    e = torch.from_numpy(enc).requires_grad_(True)
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tp.rnnt_loss_pruned(tj, e, p, torch.from_numpy(ranges), torch.from_numpy(labels),
                              torch.from_numpy(t_len), torch.from_numpy(u_len), tcfg,
                              s_range).sum()
    leaves = [tj[k][n] for k in sorted(tj) for n in sorted(tj[k])]
    grads = torch.autograd.grad(got, leaves + [e, p])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    wants = [wj[k][n] for k in sorted(tj) for n in sorted(tj[k])] + [we, wp]
    for g, w in zip(grads, wants):
        assert _rel(g.numpy(), w) <= 1e-4


def test_pruned_bundle_matches_jax():
    """The simple + pruned objective: the loss, both parts, the ranges as
    integers, and the gradients of every leaf, enc and pred."""
    jcfg, tcfg, joint, simple, enc, pred, labels, t_len, u_len = _joint_inputs(8)
    jargs = (jnp.asarray(labels), jnp.asarray(t_len), jnp.asarray(u_len), jcfg)

    def jloss(s, jt, e, p):
        loss, aux = jp.pruned_loss_bundle(s, jt, e, p, *jargs, s_range=4)
        return jnp.sum(loss), aux

    jt = jax.tree.map(jnp.asarray, joint)
    js = jax.tree.map(jnp.asarray, simple)
    (want, aux), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        js, jt, jnp.asarray(enc), jnp.asarray(pred))

    def leaf(x):
        return x.requires_grad_(True)

    ts = {k: {n: leaf(x) for n, x in v.items()} for k, v in params_from_numpy(simple).items()}
    tj = {k: {n: leaf(x) for n, x in v.items()} for k, v in params_from_numpy(joint).items()}
    e, p = leaf(torch.from_numpy(enc)), leaf(torch.from_numpy(pred))
    loss, taux = tp.pruned_loss_bundle(ts, tj, e, p, torch.from_numpy(labels),
                                       torch.from_numpy(t_len), torch.from_numpy(u_len), tcfg,
                                       s_range=4)
    np.testing.assert_array_equal(taux["ranges"].numpy(), np.asarray(aux["ranges"]))
    for name in ("simple", "pruned"):
        np.testing.assert_allclose(taux[name].detach().numpy(), np.asarray(aux[name]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(loss.sum()), float(want), rtol=1e-5)

    def flat(tree):
        return [tree[k][n] for k in sorted(tree) for n in sorted(tree[k])]

    got = torch.autograd.grad(loss.sum(), flat(ts) + flat(tj) + [e, p])
    wants = flat(wg[0]) + flat(wg[1]) + [wg[2], wg[3]]
    for g, w in zip(got, wants):
        assert _rel(g.numpy(), w) <= 1e-4
