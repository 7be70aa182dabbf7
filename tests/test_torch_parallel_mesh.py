"""The port's single-process mesh and data x tensor parallel training
(``reazonspeech_tpu_torch.parallel.mesh``, ``parallel.tensor``) against the
JAX package's, after ``tests/test_parallel.py`` and ``tests/test_trainer.py``:
the mesh's shape and refusals; ``param_spec`` leaf by leaf against JAX's on
the nemo and espnet trees; ``shard_params`` placing each split leaf's shards
on their entries and leaving whole what does not divide, as JAX's
placement; on a 4 x 2 mesh of ``cpu`` entries the train step's loss against
the single-device step's and JAX's sharded step's (rtol 1e-4), the
parameters after one AdamW step against the single-device step's (1e-5);
``Trainer(mesh=)`` and ``Trainer(pipeline=)`` each taking steps, and a mesh
Trainer's checkpoint restored."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.frontend.features import nemo_frontend_config as j_fe
from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
from reazonspeech_tpu.nemo.asr.model import init_params as j_init_params
from reazonspeech_tpu.parallel import mesh as jmesh
from reazonspeech_tpu.training import train_step as jts
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.frontend.features import nemo_frontend_config as t_fe
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt
from reazonspeech_tpu_torch.parallel import mesh as tmesh
from reazonspeech_tpu_torch.parallel.pipeline import PipelineSpec, make_pipeline_mesh
from reazonspeech_tpu_torch.training import Trainer, TrainerConfig
from reazonspeech_tpu_torch.training import train_step as tts

CPU = torch.device("cpu")
SMALL = dict(num_layers=2, d_model=128, num_heads=4, subsampling_channels=32,
             compute_dtype="float32")
RNNT = dict(vocab_size=32, enc_dim=128, pred_hidden=64, joint_hidden=64, compute_dtype="float32")
# the kernel configuration of training (the wrappers' twins on the CPU)
KERNELS = dict(attn_impl="pallas", lnd_impl="pallas", conv_impl="xla")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(n_data, n_model):
    return tmesh.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, tmesh.Shards):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def test_mesh_shapes_and_refusals():
    mesh = _cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert list(mesh.shape) == list(jmesh.make_mesh(n_data=4, n_model=2).shape)
    assert set(mesh.devices.flat) == {CPU} and mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        tmesh.make_mesh(n_data=3, n_model=3, devices=[CPU] * 8)
    # no devices given: the visible CUDA devices, never the CPU
    with pytest.raises(ValueError, match="pass devices= explicitly"):
        tmesh.make_mesh(n_data=2)
    pipe = make_pipeline_mesh(2, 2, devices=[CPU] * 4)
    assert pipe.shape == {"data": 2, "pipe": 2}


def _espnet_trees():
    from reazonspeech_tpu.espnet.asr.model import load_model_container
    from reazonspeech_tpu.models.conformer import espnet_encoder_config

    model = load_model_container(checkpoint="random", enc_cfg=espnet_encoder_config(
        num_layers=2, d_model=64, num_heads=4, subsampling_channels=32,
        compute_dtype="float32"))
    return model.params


@pytest.mark.parametrize("flavor", ["nemo", "espnet"])
def test_param_spec_matches_jax(flavor):
    if flavor == "nemo":
        jtree = j_init_params(0, JEnc(**SMALL), JRnnt(**RNNT))
    else:
        jtree = _espnet_trees()
    want = _flat(jax.tree.map(lambda spec: repr(tuple(spec)), jmesh.param_spec(jtree),
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))

    def spec_repr(tree):  # a spec tuple is a leaf here
        if isinstance(tree, dict):
            return {k: spec_repr(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec_repr(v) for v in tree]
        return repr(tree)

    got = _flat(spec_repr(tmesh.param_spec(params_from_numpy(jax.tree.map(np.asarray, jtree)))))
    assert got.keys() == want.keys() and len(got) > 20
    assert got == want
    assert sum("'model'" in s for s in got.values()) == 16  # 10 attention + 6 FFN leaves


@pytest.mark.parametrize("n_model,heads", [(2, 4), (8, 4), (3, 3)])
def test_shard_params_places_as_jax(n_model, heads):
    """Each split leaf: n_model shards (1/n_model of the split dim each, on
    its entry, concatenating back to the leaf); the leaves that do not
    divide (the 4 position-bias heads over 8 entries, 128 columns over 3)
    stay whole, as JAX's placement leaves them replicated."""
    n_data = 8 // n_model if 8 % n_model == 0 else 1
    jtree = j_init_params(0, JEnc(**{**SMALL, "num_heads": heads, "d_model": 96 if heads == 3
                                     else 128}), JRnnt(**RNNT))
    jplaced = jmesh.shard_params(jtree, jmesh.make_mesh(
        n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model]))
    params = params_from_numpy(jax.tree.map(np.asarray, jtree))
    placed = tmesh.shard_params(params, _cpu_mesh(n_data, n_model))
    flat, jflat, whole = _flat(placed), _flat(jplaced), _flat(params)
    assert flat.keys() == jflat.keys()
    n_split = 0
    for k, leaf in flat.items():
        jsplit = tmesh.MODEL_AXIS in tuple(jflat[k].sharding.spec)
        assert isinstance(leaf, tmesh.Shards) == jsplit, k
        if jsplit:
            n_split += 1
            dim = tuple(jflat[k].sharding.spec).index(tmesh.MODEL_AXIS)
            assert len(leaf) == n_model
            assert all(s.shape[dim] * n_model == whole[k].shape[dim] for s in leaf)
            assert torch.equal(torch.cat(list(leaf), dim), whole[k])
        else:
            assert torch.equal(leaf, whole[k])
    assert n_split > 0
    back = tmesh.unshard_params(placed)
    assert all(torch.equal(x, whole[k]) for k, x in _flat(back).items())


def _batch(b=8, n=16000, seed=0):
    rng = np.random.default_rng(seed)
    return {"waveform": (rng.standard_normal((b, n)) * 0.1).astype(np.float32),
            "lengths": np.array([n, n, 12000, n, 9000, n, n, 14000][:b], np.int32),
            "labels": rng.integers(0, 32, (b, 6)).astype(np.int32),
            "label_lengths": np.array([6, 6, 4, 6, 3, 6, 5, 6][:b], np.int32)}


@pytest.fixture(scope="module")
def jax_sharded_loss():
    """JAX's dp x tp train step on its emulated 4 x 2 mesh (tests/test_parallel.py)."""
    jenc, jr = JEnc(**SMALL), JRnnt(**RNNT)
    params = j_init_params(0, jenc, jr)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    init_state, train_step = jts.make_train_step(j_fe(), jenc, jr)
    mesh = jmesh.make_mesh(n_data=4, n_model=2)
    _, m = jax.jit(train_step)(init_state(jmesh.shard_params(params, mesh)),
                               jmesh.shard_batch(batch, mesh))
    return float(m["loss"]), jax.tree.map(np.asarray, params)


def _grads(params, batch, enc, rnnt, mesh=None):
    """{path: gradient} of compute_loss, split leaves' shards joined."""
    leaves = tts.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = tts.compute_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, t_fe(),
                            enc, rnnt, mesh=mesh)
    grads = iter(torch.autograd.grad(loss, leaves))

    def rebuild(tree):  # the gradients in the params' structure
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, tmesh.Shards):
            return tmesh.Shards(next(grads) for _ in tree)
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(grads)

    return _flat(tmesh.unshard_params(rebuild(params)))


@pytest.mark.parametrize("impls", ["plain", "kernels"])
def test_sharded_train_step_matches_single_device_and_jax(jax_sharded_loss, impls):
    """The loss and gradient norm of one step against the single-device
    step's and JAX's sharded loss (rtol 1e-4); every gradient against the
    single-device one (1e-5 of the leaf's largest); the parameters after one
    AdamW step within 1e-5 of the single-device step's wherever the
    gradient is not below 1e-7. Adam's first update is lr·g/(|g| + 1e-8),
    so where |g| is near 1e-8 it moves by up to lr with the gradient's
    rounding (the key bias's gradient is zero in exact arithmetic: the
    softmax ignores it); there it is held to lr."""
    want_jax, tree = jax_sharded_loss
    enc = TEnc(**SMALL, **(KERNELS if impls == "kernels" else {}))
    rnnt = TRnnt(**RNNT)
    batch = _batch()
    mesh = _cpu_mesh(4, 2)
    g1 = _grads(params_from_numpy(tree), batch, enc, rnnt)
    g2 = _grads(tmesh.shard_params(params_from_numpy(tree), mesh), batch, enc, rnnt, mesh)
    assert g1.keys() == g2.keys()
    for k in g1:
        scale = 1.0 if k.endswith("attn_k/b") else g1[k].abs().max().item()
        assert (g2[k] - g1[k]).abs().max().item() <= 1e-5 * scale, k

    init_1, step_1 = tts.make_train_step(t_fe(), enc, rnnt)
    s1, m1 = step_1(init_1(params_from_numpy(tree)), batch)
    init_2, step_2 = tts.make_train_step(t_fe(), enc, rnnt, mesh=mesh)
    s2, m2 = step_2(init_2(tmesh.shard_params(params_from_numpy(tree), mesh)), batch)
    loss1, loss2 = float(m1["loss"]), float(m2["loss"])
    np.testing.assert_allclose(loss2, loss1, rtol=1e-4)
    np.testing.assert_allclose(loss2, want_jax, rtol=1e-4)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-4)
    assert s2.step == 1
    got, want = _flat(tmesh.unshard_params(s2.params)), _flat(s1.params)
    assert got.keys() == want.keys()
    for k in want:
        err = (got[k] - want[k]).abs()
        assert err.max().item() <= 1e-4, k  # lr: Adam's first step is at most lr
        assert torch.where(g1[k].abs() >= 1e-7, err, 0).max().item() <= 1e-5, k


def test_a_sub_block_that_does_not_divide_runs_whole():
    """3 heads over 2 model entries: the attention's head biases stay whole,
    so the attention runs unsplit on the residual's entry while the FFNs
    split; the loss equals the single-device one."""
    cfg = dict(SMALL, d_model=96, num_heads=3, **KERNELS)
    jtree = j_init_params(0, JEnc(**{**SMALL, "d_model": 96, "num_heads": 3}),
                          JRnnt(**{**RNNT, "enc_dim": 96}))
    tree = jax.tree.map(np.asarray, jtree)
    enc, rnnt = TEnc(**cfg), TRnnt(**{**RNNT, "enc_dim": 96})
    mesh = _cpu_mesh(1, 2)
    placed = tmesh.shard_params(params_from_numpy(tree), mesh)
    blocks = placed["encoder"]["blocks"]
    assert not isinstance(blocks["attn_bias_u"], tmesh.Shards)
    assert isinstance(blocks["attn_q"]["w"], tmesh.Shards)
    assert isinstance(blocks["ffn1_in"]["w"], tmesh.Shards)
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=2).items()}
    want = tts.compute_loss(params_from_numpy(tree), batch, t_fe(), enc, rnnt)
    got = tts.compute_loss(placed, batch, t_fe(), enc, rnnt, mesh=mesh)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sharded_batch_must_divide():
    enc, rnnt = TEnc(**SMALL), TRnnt(**RNNT)
    mesh = _cpu_mesh(4, 2)
    params = tmesh.shard_params(params_from_numpy(
        jax.tree.map(np.asarray, j_init_params(0, JEnc(**SMALL), JRnnt(**RNNT)))), mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=6).items()}
    with pytest.raises(ValueError, match="does not divide"):
        tts.compute_loss(params, batch, t_fe(), enc, rnnt, mesh=mesh)
    shards = tmesh.shard_batch({k: v[:4] for k, v in batch.items()}, mesh)
    assert len(shards) == 4 and all(s["waveform"].shape[0] == 1 for s in shards)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(batch, mesh)


def test_trainer_mesh_and_pipeline_take_steps(tmp_path):
    """Trainer(mesh=4x2) and Trainer(pipeline=dp 2 x pp 2) each take two
    steps (finite, the loss recorded); the mesh Trainer's checkpoint
    restores onto the same sharded layout; the refusal of both at once."""
    enc = TEnc(**{**SMALL, "num_layers": 2, **KERNELS, "remat": True})
    rnnt = TRnnt(**RNNT)
    tree = jax.tree.map(np.asarray, j_init_params(0, JEnc(**SMALL), JRnnt(**RNNT)))
    cfg = TrainerConfig(warmup_steps=1, decay_steps=10, log_every=1,
                        checkpoint_dir=str(tmp_path), save_every=2)
    batches = [_batch(seed=s) for s in range(2)]
    tr = Trainer(t_fe(), enc, rnnt, cfg, mesh=_cpu_mesh(4, 2)).init(params_from_numpy(tree))
    assert isinstance(tr.state.params["encoder"]["blocks"]["ffn1_in"]["w"], tmesh.Shards)
    hist = tr.fit(batches, max_steps=2)
    assert [r["step"] for r in hist] == [1, 2] and all(np.isfinite(r["loss"]) for r in hist)
    back = Trainer(t_fe(), enc, rnnt, cfg, mesh=_cpu_mesh(4, 2)).restore_latest(
        params_from_numpy(tree))
    assert back.state.step == 2
    assert all(torch.equal(x, y) for x, y in zip(tts.tree_leaves(back.state.params),
                                                 tts.tree_leaves(tr.state.params)))
    spec = PipelineSpec(mesh=make_pipeline_mesh(2, 2, devices=[CPU] * 4), data_axis="data",
                        n_micro=2)
    tp = Trainer(t_fe(), enc, rnnt, TrainerConfig(warmup_steps=1, decay_steps=10, log_every=1),
                 pipeline=spec).init(params_from_numpy(tree))
    assert isinstance(tp.state.params["encoder"]["blocks"], list)
    hist = tp.fit(batches, max_steps=2)
    assert [r["step"] for r in hist] == [1, 2] and all(np.isfinite(r["loss"]) for r in hist)
    with pytest.raises(ValueError, match="not both"):
        Trainer(t_fe(), enc, rnnt, mesh=_cpu_mesh(4, 2), pipeline=spec)
