"""The port's GPipe encoder (``reazonspeech_tpu_torch.parallel.pipeline``)
against the JAX package's on the same tree (JAX on its emulated devices, the
port's mesh repeating ``cpu``), fp32, after ``tests/test_pipeline_parallel.py``:
the encode at S = 2 and 4, with and without ``final_norm``, dp x pp, remat
and an explicit ``n_micro``, each within 1e-5 of JAX and equal to the port's
own single-device encode; every ``_resolve_schedule`` refusal with JAX's
message; gradients through the schedule against the single-device ones at
S = 2 and S = 4 within 1e-5; the pipeline train step's loss against JAX's
and the single-device step's; ``shard_params_pipeline``'s placement."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
from reazonspeech_tpu.models.fastconformer import init_fastconformer as j_init
from reazonspeech_tpu.parallel import pipeline as jpp
from reazonspeech_tpu.parallel.sequence import use_mesh
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
from reazonspeech_tpu_torch.models.fastconformer import fastconformer_encode
from reazonspeech_tpu_torch.parallel import pipeline as tpp

SMALL = dict(num_layers=4, d_model=64, num_heads=4, ff_expansion=2, subsampling_channels=16,
             compute_dtype="float32", attn_impl="xla", conv_impl="xla", lnd_impl="xla")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    return JEnc(**SMALL, **kw), TEnc(**SMALL, **kw)


def _tree(jcfg, seed):
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    blocks = tree["blocks"]
    for name in ("attn_bias_u", "attn_bias_v"):  # zeros at init: make them count
        blocks[name] = (0.1 * rng.standard_normal(blocks[name].shape)).astype(np.float32)
    return tree


def _inputs(b=4, t=64, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 80)).astype(np.float32)
    return feats, np.array([t, t - 14, t // 2 + 1, t], np.int32)[:b]


def _port_mesh(n_pipe, n_data=1):
    return tpp.make_pipeline_mesh(n_pipe, n_data, devices=[CPU] * (n_pipe * n_data))


def _jax_mesh(n_pipe, n_data=1):
    return jpp.make_pipeline_mesh(n_pipe, n_data, devices=jax.devices()[:n_pipe * n_data])


CASES = {  # name: (config overrides, n_pipe, n_data, n_micro, seed)
    "S2": ({}, 2, 1, None, 0),
    "S4": ({}, 4, 1, None, 0),
    "S4_final_norm": (dict(final_norm=True), 4, 1, None, 0),
    "S2_final_norm": (dict(final_norm=True), 2, 1, None, 3),
    "dp2_pp4": ({}, 4, 2, 2, 1),
    "remat_S2_M4": (dict(remat=True), 2, 1, 4, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_encode_matches_jax_and_local(case):
    kw, n_pipe, n_data, n_micro, seed = CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    tree = _tree(jcfg, seed)
    feats, flens = _inputs(seed=seed)
    data_axis = "data" if n_data > 1 else None
    want, want_lens = jpp.pipeline_parallel_encode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(feats), jnp.asarray(flens), jcfg,
        _jax_mesh(n_pipe, n_data), data_axis=data_axis, n_micro=n_micro)
    params = params_from_numpy(tree)
    got, got_lens = tpp.pipeline_parallel_encode(
        params, torch.from_numpy(feats), torch.from_numpy(flens), tcfg,
        _port_mesh(n_pipe, n_data), data_axis=data_axis, n_micro=n_micro)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err < 1e-5, err
    local, _ = fastconformer_encode(params, torch.from_numpy(feats), torch.from_numpy(flens),
                                    tcfg)
    assert torch.equal(got, local)  # the same blocks on the same rows


def test_pipeline_runs_the_kernel_wrappers_per_stage():
    """The serving configuration's kernel impls (their plain twins on the
    CPU) run unchanged inside each stage, pre-sharded or not."""
    _, tcfg = _cfgs()
    tcfg = replace(tcfg, d_model=128, num_heads=8, attn_impl="pallas", lnd_impl="pallas",
                   conv_impl="pallas")
    from reazonspeech_tpu_torch.models.fastconformer import init_fastconformer

    params = init_fastconformer(torch.Generator().manual_seed(5), tcfg)
    feats, flens = (torch.from_numpy(a) for a in _inputs(seed=5))
    mesh = _port_mesh(2)
    local, _ = fastconformer_encode(params, feats, flens, tcfg)
    for tree in (params, tpp.shard_params_pipeline(params, mesh)):
        got, _ = tpp.pipeline_parallel_encode(tree, feats, flens, tcfg, mesh)
        assert torch.equal(got, local)


REFUSALS = {  # name: (config overrides, batch, n_pipe, n_data, data axis?, n_micro)
    "seq_axis": (dict(seq_axis="model"), 4, 2, 1, False, None),
    "depth": ({}, 4, 3, 1, False, None),
    "no_default": ({}, 3, 2, 2, True, None),
    "batch": ({}, 4, 2, 1, False, 3),
    "microbatch": ({}, 4, 2, 2, True, 4),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_resolve_schedule_refuses_as_jax(case):
    kw, b, n_pipe, n_data, dp, n_micro = REFUSALS[case]
    jcfg, tcfg = _cfgs(**kw)
    data_axis = "data" if dp else None
    with pytest.raises(ValueError) as want:
        jpp._resolve_schedule(b, jcfg, _jax_mesh(n_pipe, n_data), "pipe", data_axis, n_micro)
    with pytest.raises(ValueError) as got:
        tpp._resolve_schedule(b, tcfg, _port_mesh(n_pipe, n_data), "pipe", data_axis, n_micro)
    assert str(got.value) == str(want.value)


def _grad_err(want, got):
    """The largest leaf error relative to the leaf's largest value (as the
    JAX test's ``_grad_err``)."""
    return max((g - w).abs().max().item() / (w.abs().max().item() + 1e-8)
               for w, g in zip(want, got))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("n_pipe,n_data,n_micro", [(2, 1, 1), (2, 2, 2), (4, 1, 1), (4, 1, 4)])
def test_pipeline_gradients_match_single_device(n_pipe, n_data, n_micro):
    """Autograd through the schedule is the backward pipeline: the
    gradients equal the single-device encode's of the whole batch (the
    prologue runs on the whole batch in both; the weights' gradients sum
    over the microbatches, an fp32 reorder)."""
    jcfg, tcfg = _cfgs(remat=True)
    tree = _tree(jcfg, 3)
    feats, flens = (torch.from_numpy(a) for a in _inputs(seed=3))
    mesh = _port_mesh(n_pipe, n_data)
    data_axis = "data" if n_data > 1 else None

    def grads(fn, shard=False):
        params = params_from_numpy(tree)
        if shard:
            params = tpp.shard_params_pipeline(params, mesh)
        leaves = _leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss = fn(params)
        return torch.autograd.grad(loss, leaves)

    def local(p):
        return fastconformer_encode(p, feats, flens, tcfg)[0].square().sum()

    def piped(p):
        enc, _ = tpp.pipeline_encode_core(p, feats, flens, tcfg, mesh, "pipe", data_axis,
                                          n_micro)
        return enc.square().sum()

    want = grads(local)
    assert _grad_err(want, grads(piped)) < 1e-5
    # pre-sharded stages: the same leaves, split into stage lists
    got = grads(piped, shard=True)
    assert len(got) == len(want) + (n_pipe - 1) * len(_leaves(tree["blocks"]))
    stages = [torch.cat(parts) for parts in zip(*[
        got[i:i + len(_leaves(tree["blocks"]))]
        for i in range(0, n_pipe * len(_leaves(tree["blocks"])), len(_leaves(tree["blocks"])))])]
    rest = got[n_pipe * len(_leaves(tree["blocks"])):]
    assert _grad_err(want, stages + list(rest)) < 1e-5


def test_pipeline_train_step_matches_jax_and_single_device():
    """The RNN-T loss with the encoder under the schedule (dp 2 x pp 2,
    2 microbatches, remat) against JAX's compute_loss(pipeline=...) and the
    port's single-device step; the step's gradient norm against the
    single-device one; the update applied."""
    from reazonspeech_tpu.frontend.features import nemo_frontend_config as j_fe
    from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
    from reazonspeech_tpu.nemo.asr.model import init_params as j_init_params
    from reazonspeech_tpu.training import train_step as jts
    from reazonspeech_tpu_torch.frontend.features import nemo_frontend_config as t_fe
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt
    from reazonspeech_tpu_torch.training import train_step as tts

    jcfg, tcfg = _cfgs(remat=True)
    rkw = dict(vocab_size=32, enc_dim=64, pred_hidden=32, joint_hidden=32,
               compute_dtype="float32")
    jr, tr = JRnnt(**rkw), TRnnt(**rkw)
    tree = jax.tree.map(np.asarray, j_init_params(0, jcfg, jr))
    rng = np.random.default_rng(0)
    batch = {"waveform": (rng.standard_normal((4, 16000)) * 0.1).astype(np.float32),
             "lengths": np.array([16000, 12000, 16000, 9000], np.int32),
             "labels": rng.integers(1, 32, (4, 6)).astype(np.int32),
             "label_lengths": np.array([6, 4, 6, 3], np.int32)}
    jmesh = _jax_mesh(2, 2)
    jspec = jpp.PipelineSpec(mesh=jmesh, data_axis="data", n_micro=2)
    with use_mesh(jmesh):
        want = float(jax.jit(lambda p, b: jts.compute_loss(p, b, j_fe(), jcfg, jr,
                                                           pipeline=jspec))(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}))

    spec = tpp.PipelineSpec(mesh=_port_mesh(2, 2), data_axis="data", n_micro=2)
    init_pp, step_pp = tts.make_train_step(t_fe(), tcfg, tr, pipeline=spec)
    state, m_pp = step_pp(init_pp(tpp.shard_params_pipeline(params_from_numpy(tree),
                                                            spec.mesh)), batch)
    init_1, step_1 = tts.make_train_step(t_fe(), tcfg, tr)
    _, m_1 = step_1(init_1(params_from_numpy(tree)), batch)
    loss = float(m_pp["loss"])
    assert abs(loss - want) <= 1e-4 * abs(want), (loss, want)
    assert abs(loss - float(m_1["loss"])) <= 1e-6 * abs(float(m_1["loss"]))
    g_rel = abs(float(m_pp["grad_norm"]) - float(m_1["grad_norm"])) / float(m_1["grad_norm"])
    assert g_rel < 1e-5, g_rel
    assert state.step == 1
    before = tts.tree_leaves(params_from_numpy(tree)["joint"])
    assert all(not torch.equal(x, y) for x, y in zip(tts.tree_leaves(state.params["joint"]),
                                                      before))


def test_shard_params_pipeline_places_stages():
    """L/S blocks on each stage's entry, the stage lists in layer order; a
    depth that does not divide stays whole; a full model tree keeps its
    other entries."""
    jcfg, _ = _cfgs()
    tree = params_from_numpy(_tree(jcfg, 4))
    placed = tpp.shard_params_pipeline({"encoder": tree, "joint": {"w": torch.ones(2)}},
                                       _port_mesh(2))
    blocks = placed["encoder"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == 2
    for s, stage in enumerate(blocks):
        assert torch.equal(stage["ffn1_in"]["w"], tree["blocks"]["ffn1_in"]["w"][2 * s:2 * s + 2])
    assert torch.equal(placed["joint"]["w"], torch.ones(2))
    whole = tpp.shard_params_pipeline(tree, _port_mesh(3))
    assert torch.equal(whole["blocks"]["ffn1_in"]["w"], tree["blocks"]["ffn1_in"]["w"])
