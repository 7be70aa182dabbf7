"""The port's cache-based streaming FastConformer against the JAX package on
the same weights (carried by ``convert/from_jax.py``) and the same seeded
mels: B = 2, ``StreamingConfig(4, 8, 16)``, four chunks, the tiny encoder
with non-trivial LayerNorm affines, batch-norm statistics and attention
biases. The JAX steps run once per configuration in a module fixture
(``streaming_step`` jitted, as ``tests/test_streaming.py`` runs it; its
``ln_dense`` kernel in interpret mode). Tolerances: fp32 outputs and state
leaves within 1e-5; bf16 compute within 5e-2 max abs (outputs are
LayerNorm-ed, O(1): a few bf16 ulps of the projections' inputs, carried
through two blocks and four chunks of caches)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reazonspeech_tpu.models import fastconformer as jfc
from reazonspeech_tpu.models import fastconformer_streaming as jfs
from reazonspeech_tpu.ops.testing import interpret_serving_kernels
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.models import fastconformer as tfc
from reazonspeech_tpu_torch.models import fastconformer_streaming as tfs
from reazonspeech_tpu_torch.ops import launch_counts, reset_launch_counts

B, N_CHUNKS = 2, 4
SCFG = dict(chunk_frames=4, left_context=8, sub_context=16)
MEL_PER_CHUNK = 8 * SCFG["chunk_frames"]
# name -> tiny-config overrides; "pallas" is d=128 so that the JAX encoder
# takes its ln_dense kernel (ln_dense_supported wants 128-aligned widths)
CONFIGS = {
    "fp32": dict(compute_dtype="float32"),
    "pallas": dict(compute_dtype="float32", d_model=128, lnd_impl="pallas"),
    "bf16": dict(compute_dtype="bfloat16"),
    "layer_norm": dict(compute_dtype="float32", conv_norm="layer_norm", final_norm=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module (the other test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, seed):
    """Non-trivial LN affines, batch-norm statistics and attention biases
    (init leaves them at identity/zero)."""
    rng = np.random.default_rng(seed)
    blocks = tree["blocks"]
    norms = ["ffn1_ln", "attn_ln", "conv_ln", "ffn2_ln", "final_ln"]
    if "mean" not in blocks["conv_bn"]:
        norms.append("conv_bn")
    for name in norms:
        blocks[name]["scale"] = (1.0 + 0.1 * rng.standard_normal(
            blocks[name]["scale"].shape)).astype(np.float32)
        blocks[name]["bias"] = (0.1 * rng.standard_normal(
            blocks[name]["bias"].shape)).astype(np.float32)
    if "mean" in blocks["conv_bn"]:
        bn = blocks["conv_bn"]
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    for name in ("attn_bias_u", "attn_bias_v"):
        blocks[name] = (0.1 * rng.standard_normal(blocks[name].shape)).astype(np.float32)
    return tree


def _mels(b, t, f, seed):
    return np.random.default_rng(seed).standard_normal((b, t, f)).astype(np.float32)


def _jax_steps(jcfg, tree, feats, scfg):
    """JAX streaming_step over every chunk: ([out per chunk], [state after
    each step]) as numpy."""
    params = jax.tree.map(jnp.asarray, tree)
    state = jfs.streaming_init_state(jcfg, scfg, feats.shape[0])
    outs, states = [], []
    for i in range(feats.shape[1] // MEL_PER_CHUNK):
        chunk = jnp.asarray(feats[:, i * MEL_PER_CHUNK:(i + 1) * MEL_PER_CHUNK])
        out, state = jfs.streaming_step(params, state, chunk, jcfg, scfg)
        outs.append(np.asarray(out.astype(jnp.float32)))
        states.append(jax.tree.map(np.asarray, state))
    return outs, states


@pytest.fixture(scope="module")
def cases():
    """name -> (torch cfg, torch params, mels, JAX outs, JAX states)."""
    out = {}
    feats = _mels(B, N_CHUNKS * MEL_PER_CHUNK, 80, seed=0)
    jscfg = jfs.StreamingConfig(**SCFG)
    with interpret_serving_kernels():
        for name, kw in CONFIGS.items():
            jcfg = jfc.FastConformerConfig.tiny(**kw)
            tree = jax.tree.map(np.asarray, jfc.init_fastconformer(jax.random.PRNGKey(0), jcfg))
            tree = _randomize(tree, seed=1)
            outs, states = _jax_steps(jcfg, tree, feats, jscfg)
            out[name] = (tfc.FastConformerConfig.tiny(**kw), params_from_numpy(tree), feats,
                         outs, states)
    return out


def _port_steps(cfg, params, feats):
    scfg = tfs.StreamingConfig(**SCFG)
    state = tfs.streaming_init_state(cfg, scfg, feats.shape[0], device="cpu")
    outs, states = [], []
    for i in range(feats.shape[1] // MEL_PER_CHUNK):
        chunk = torch.from_numpy(feats[:, i * MEL_PER_CHUNK:(i + 1) * MEL_PER_CHUNK])
        o, state = tfs.streaming_step(params, state, chunk, cfg, scfg)
        outs.append(o)
        states.append(state)
    return outs, states


def test_chunks_and_state_match_jax_fp32(cases):
    """Each chunk's output and every state leaf after each step within
    1e-5 of the JAX package's, at fp32."""
    cfg, params, feats, want_outs, want_states = cases["fp32"]
    outs, states = _port_steps(cfg, params, feats)
    assert len(outs) == N_CHUNKS
    for i, (o, w) in enumerate(zip(outs, want_outs)):
        assert o.dtype == torch.float32 and tuple(o.shape) == w.shape
        np.testing.assert_allclose(o.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=f"chunk {i}")
    for i, (s, w) in enumerate(zip(states, want_states)):
        assert set(s) == set(w)
        for key in w:
            got = s[key].numpy()
            assert got.dtype == w[key].dtype and got.shape == w[key].shape, key
            np.testing.assert_allclose(got, w[key], atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {i} {key}")


@pytest.mark.parametrize("name", ["pallas", "layer_norm"])
def test_variants_match_jax(cases, name):
    """lnd_impl="pallas" (the JAX ln_dense kernel in interpret mode, the
    port's plain twin on CPU tensors) and conv_norm="layer_norm" with the
    encoder's final_norm: every chunk within 1e-5 at fp32."""
    cfg, params, feats, want_outs, _ = cases[name]
    outs, _ = _port_steps(cfg, params, feats)
    for i, (o, w) in enumerate(zip(outs, want_outs)):
        np.testing.assert_allclose(o.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=f"chunk {i}")


def test_bf16_compute_matches_jax(cases):
    """bf16 compute, fp32 stream and caches: every chunk within 5e-2 max
    abs of the JAX package's, and well inside it on average."""
    cfg, params, feats, want_outs, _ = cases["bf16"]
    outs, states = _port_steps(cfg, params, feats)
    got, want = torch.cat(outs, 1).numpy(), np.concatenate(want_outs, 1)
    assert got.dtype == np.float32
    assert states[-1]["x_cache"].dtype == torch.float32
    assert np.abs(got - want).max() <= 5e-2
    assert np.abs(got - want).mean() <= 5e-3


def test_encode_equals_stepping(cases):
    """streaming_encode is the stepped loop: bit-equal."""
    cfg, params, feats, _, _ = cases["fp32"]
    outs, _ = _port_steps(cfg, params, feats)
    scanned = tfs.streaming_encode(params, torch.from_numpy(feats), cfg,
                                   tfs.StreamingConfig(**SCFG))
    assert torch.equal(scanned, torch.cat(outs, dim=1))


def test_causality(cases):
    """Changing the last chunk's mels leaves every earlier output bit-equal
    and changes the last chunk's."""
    cfg, params, _, _, _ = cases["fp32"]
    scfg, c = tfs.StreamingConfig(**SCFG), SCFG["chunk_frames"]
    f1 = _mels(1, N_CHUNKS * MEL_PER_CHUNK, 80, seed=1)
    f2 = f1.copy()
    f2[:, -MEL_PER_CHUNK:] += 5.0
    o1 = tfs.streaming_encode(params, torch.from_numpy(f1), cfg, scfg)
    o2 = tfs.streaming_encode(params, torch.from_numpy(f2), cfg, scfg)
    assert torch.equal(o1[:, :-c], o2[:, :-c])
    assert not torch.allclose(o1[:, -c:], o2[:, -c:], atol=1e-3)


def test_left_context_is_used(cases):
    """The first chunk's mels change the second chunk's output: the caches
    carry information."""
    cfg, params, _, _, _ = cases["fp32"]
    scfg, c = tfs.StreamingConfig(**SCFG), SCFG["chunk_frames"]
    f1 = _mels(1, 2 * MEL_PER_CHUNK, 80, seed=2)
    f2 = f1.copy()
    f2[:, :MEL_PER_CHUNK] += 5.0
    o1 = tfs.streaming_encode(params, torch.from_numpy(f1), cfg, scfg)
    o2 = tfs.streaming_encode(params, torch.from_numpy(f2), cfg, scfg)
    assert not torch.allclose(o1[:, c:], o2[:, c:], atol=1e-3)


def test_shapes_state_and_no_launch(cases):
    """A trailing partial chunk is dropped; the state holds the JAX keys
    and shapes on the params' device; no mel chunk gives [B, 0, D]; the CPU
    path launches no CUDA kernel; init_state with no device means the card."""
    cfg, params, _, _, _ = cases["fp32"]
    scfg = tfs.StreamingConfig(**SCFG)
    feats = torch.from_numpy(_mels(1, 3 * MEL_PER_CHUNK + 17, 80, seed=3))
    reset_launch_counts()
    out = tfs.streaming_encode(params, feats, cfg, scfg)
    assert sum(launch_counts().values()) == 0
    assert tuple(out.shape) == (1, 3 * scfg.chunk_frames, cfg.d_model)
    assert bool(torch.isfinite(out).all())
    assert tuple(tfs.streaming_encode(params, feats[:, :10], cfg, scfg).shape) == (1, 0, 64)
    state = tfs.streaming_init_state(cfg, scfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "mel_cache": (3, 16, 80), "x_cache": (2, 3, 8, 64), "conv_cache": (2, 3, 8, 64),
        "frames_seen": (3,)}
    assert state["frames_seen"].dtype == torch.int32
    _, new = tfs.streaming_step(params, state, feats[:1].expand(3, -1, -1)[:, :MEL_PER_CHUNK],
                                cfg, scfg)
    assert new["frames_seen"].tolist() == [4, 4, 4]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfs.streaming_init_state(cfg, scfg, 1)


def test_default_config_is_the_jax_one():
    """StreamingConfig's defaults are the JAX package's (16-frame chunks,
    1.28 s; left context 64; sub-context 16)."""
    assert tfs.StreamingConfig() == tfs.StreamingConfig(16, 64, 16)
    j = jfs.StreamingConfig()
    assert (j.chunk_frames, j.left_context, j.sub_context) == (16, 64, 16)
