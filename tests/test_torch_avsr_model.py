"""The port's AVSR model (``reazonspeech_tpu_torch.avsr``) against the JAX
package's on the same weights, at the tiny config in fp32.

One JAX-initialised tree feeds both packages (``convert/from_jax``). Tensors
are held within 1e-5 relative (L2), tokens must be equal: the ResNet3D
trunk, the grouped conv position embedding at an even and an odd kernel,
the encoder (each modality, both fusions, with lengths), teacher forcing,
the cached decoder step, greedy and beam-5 generate (with EOS made to rank:
the banking pool, exact ties, elements that finish before ``max_length``),
and the loss with and without its CTC term.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reazonspeech_tpu.avsr import AVHubertConfig as JaxConfig
from reazonspeech_tpu.avsr import AVHubertForConditionalGeneration as JaxGen
from reazonspeech_tpu.avsr import AVHubertModel as JaxModel
from reazonspeech_tpu.avsr import model as jax_model
from reazonspeech_tpu.avsr import resnet3d as jax_resnet
from reazonspeech_tpu_torch.avsr import (
    AVHubertConfig,
    AVHubertForConditionalGeneration,
    AVHubertModel,
)
from reazonspeech_tpu_torch.avsr import model as port_model
from reazonspeech_tpu_torch.avsr import resnet3d as port_resnet
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy

RTOL = 1e-5
JAX_CFG = JaxConfig.tiny(audio_feat_dim=104)
CFG = AVHubertConfig.tiny(audio_feat_dim=104)
# the token the unscaled tiny model emits most on _inputs(); EOS's row of
# the tied embedding becomes a multiple of this one's to make EOS rank
EOS_TWIN = 52


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: at torch's default (one
    thread a core) each test worker's OpenMP team oversubscribes the cores
    that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    """The JAX-initialised tiny tree, numpy leaves."""
    return jax.tree.map(np.asarray, JaxGen.init(jax.random.PRNGKey(0), JAX_CFG).params)


def _pair(tree, jax_cfg=JAX_CFG, cfg=CFG):
    return (JaxGen(config=jax_cfg, params=jax.tree.map(jnp.asarray, tree)),
            AVHubertForConditionalGeneration(config=cfg, params=params_from_numpy(tree)))


def _inputs(b=3, t=16, seed=5):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((b, t, 104)).astype(np.float32)
    video = rng.standard_normal((b, t, 88, 88)).astype(np.float32) * 0.5
    lengths = np.array([t, t - 5, t - 9][:b], np.int32)
    return audio, video, lengths


def test_resnet3d_matches_jax(tree):
    video = np.random.default_rng(0).standard_normal((1, 5, 88, 88)).astype(np.float32)
    want = jax_resnet.resnet3d_apply(jax.tree.map(jnp.asarray, tree["video_resnet"]),
                                     jnp.asarray(video))
    got = port_resnet.resnet3d_apply(params_from_numpy(tree["video_resnet"]),
                                     torch.from_numpy(video))
    assert got.shape == (1, 5, port_resnet.RESNET_OUT_DIM)
    assert rel(got, want) < RTOL


def test_resnet3d_scalar_prelu(tree):
    """A (1,)-shaped PReLU alpha acts as a scalar, as in the JAX trunk (the
    converter writes one where a checkpoint has a shared slope)."""
    t = jax.tree.map(np.copy, tree["video_resnet"])
    t["front_relu"]["alpha"] = np.array([0.1], np.float32)
    t["stages"][1][0]["relu2"]["alpha"] = np.array([0.3], np.float32)
    video = np.random.default_rng(1).standard_normal((1, 3, 88, 88)).astype(np.float32)
    want = jax_resnet.resnet3d_apply(jax.tree.map(jnp.asarray, t), jnp.asarray(video))
    got = port_resnet.resnet3d_apply(params_from_numpy(t), torch.from_numpy(video))
    assert rel(got, want) < RTOL


@pytest.mark.parametrize("kernel", [16, 15])
def test_conv_pos_embed_matches_jax(kernel):
    """The grouped conv position embedding: padding K//2, the trailing frame
    dropped for an even K (the published K = 128 is even)."""
    d, groups = 32, 4
    p = jax.tree.map(np.asarray, jax_model._conv_pos_init(jax.random.PRNGKey(kernel), d,
                                                          kernel, groups))
    x = np.random.default_rng(kernel).standard_normal((2, 11, d)).astype(np.float32)
    want = jax_model._conv_pos_embed(jax.tree.map(jnp.asarray, p), jnp.asarray(x), groups,
                                     jnp.float32)
    got = port_model._conv_pos_embed(params_from_numpy(p), torch.from_numpy(x), groups)
    assert got.shape == (2, 11, d)
    assert rel(got, want) < RTOL


def _add_fusion(tree):
    """The same tree for ``modality_fuse="add"`` (fused dim = hidden: no
    post projection, a fuse LayerNorm of the hidden width)."""
    t = {k: v for k, v in tree.items() if k != "post_proj"}
    rng = np.random.default_rng(7)
    d = JAX_CFG.hidden_size
    t["fuse_ln"] = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
                    "bias": rng.standard_normal(d).astype(np.float32) * 0.1}
    return t


@pytest.mark.parametrize("fuse", ["concat", "add"])
@pytest.mark.parametrize("modalities", [("audio",), ("video",), ("audio", "video")])
def test_encode_matches_jax(tree, fuse, modalities):
    jax_cfg, cfg = (JaxConfig.tiny(audio_feat_dim=104, modality_fuse=fuse),
                    AVHubertConfig.tiny(audio_feat_dim=104, modality_fuse=fuse))
    t = tree if fuse == "concat" else _add_fusion(tree)
    audio, video, lengths = _inputs(b=2, t=12)
    kw = {k: v for k, v in (("audio", audio), ("video", video)) if k in modalities}
    want, want_mask = JaxModel(config=jax_cfg, params=jax.tree.map(jnp.asarray, t))(
        lengths=jnp.asarray(lengths), **kw)
    got, mask = AVHubertModel(config=cfg, params=params_from_numpy(t))(lengths=lengths, **kw)
    assert got.shape == (2, 12, cfg.hidden_size)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert rel(got, want) < RTOL


def test_encode_needs_a_modality(tree):
    _, port = _pair(tree)
    with pytest.raises(ValueError, match="at least one"):
        port.encoder()


def test_decode_logits_matches_jax(tree):
    jm, port = _pair(tree)
    audio, video, lengths = _inputs()
    ids = np.random.default_rng(2).integers(0, CFG.vocab_size, (3, 6)).astype(np.int32)
    want = jm.forward_logits(ids, audio=audio, video=video, lengths=jnp.asarray(lengths))
    got = port.forward_logits(ids, audio=audio, video=video, lengths=lengths)
    assert got.shape == (3, 6, CFG.vocab_size)
    assert rel(got, want) < RTOL


def test_cached_step_matches_teacher_forcing(tree):
    """Step u of the KV-cached decoder gives the teacher-forced logits at u,
    the JAX package's and the port's own."""
    jm, port = _pair(tree)
    audio, video, lengths = _inputs()
    ids = np.random.default_rng(3).integers(0, CFG.vocab_size, (3, 7)).astype(np.int64)
    want = np.asarray(jm.forward_logits(ids, audio=audio, video=video,
                                        lengths=jnp.asarray(lengths)))
    own = port.forward_logits(ids, audio=audio, video=video, lengths=lengths).numpy()
    with torch.inference_mode():
        enc, mask = port.encoder(audio, video, lengths)
        dec = port_model._Decoder(port.params, CFG, enc, mask, max_length=10)
        kc, vc = dec.caches(3)
        steps = [dec.step(torch.from_numpy(ids[:, u]), u, kc, vc).numpy() for u in range(7)]
    got = np.stack(steps, axis=1)
    assert rel(got, want) < RTOL
    assert rel(got, own) < RTOL


def _eos_tree(tree, factor):
    """EOS's row of the tied embedding = ``factor`` × EOS_TWIN's row (None:
    the tree as it is, where EOS never ranks)."""
    if factor is None:
        return tree
    t = dict(tree)
    table = tree["embed_tokens"]["table"].copy()
    table[JAX_CFG.eos_token_id] = table[EOS_TWIN] * factor
    t["embed_tokens"] = {"table": table}
    return t


def _count_steps(monkeypatch):
    steps = []
    step = port_model._Decoder.step

    def counted(self, *args):
        steps.append(1)
        return step(self, *args)

    monkeypatch.setattr(port_model._Decoder, "step", counted)
    return steps


@pytest.fixture(scope="module")
def encoded(tree):
    """Each package's encoder output on _inputs(), with its mask: the EOS
    row of the embedding, all that the generate tests change, is not read
    by the encoder."""
    jm, port = _pair(tree)
    audio, video, lengths = _inputs()
    return (jm.encoder(audio=audio, video=video, lengths=jnp.asarray(lengths)),
            port.encoder(audio, video, lengths))


@functools.lru_cache(maxsize=None)
def _jax_decode(num_beams, max_length):
    """The JAX package's greedy or beam decode from an encoder output, jitted."""
    if num_beams <= 1:
        return jax.jit(lambda p, enc, mask: jax_model.greedy_generate(p, JAX_CFG, enc, mask,
                                                                      max_length))
    return jax.jit(lambda p, enc, mask: jax_model.beam_generate(p, JAX_CFG, enc, mask,
                                                                num_beams, max_length))


def _generate_both(tree, encoded, num_beams, max_length):
    (jax_enc, jax_mask), (enc, mask) = encoded
    want = np.asarray(_jax_decode(num_beams, max_length)(jax.tree.map(jnp.asarray, tree),
                                                         jax_enc, jax_mask))
    params = params_from_numpy(tree)
    with torch.inference_mode():
        if num_beams <= 1:
            got = port_model.greedy_generate(params, CFG, enc, mask, max_length)
        else:
            got = port_model.beam_generate(params, CFG, enc, mask, num_beams, max_length)
    assert got.shape == (3, max_length)
    return got.numpy(), want


# (EOS factor, max_length, every element done before max_length)
@pytest.mark.parametrize("factor,max_length,early", [
    (None, 10, False),
    (1.0, 48, True),   # EOS ties EOS_TWIN exactly: the lower index, EOS, wins
])
def test_greedy_generate_matches_jax(tree, encoded, monkeypatch, factor, max_length, early):
    monkeypatch.setattr(port_model, "CHECK_EVERY", 8)
    steps = _count_steps(monkeypatch)
    got, want = _generate_both(_eos_tree(tree, factor), encoded, 1, max_length)
    np.testing.assert_array_equal(got, want)
    assert (len(steps) < max_length) == early


@pytest.mark.parametrize("factor,max_length,early", [
    (None, 8, False),   # EOS never ranks: the survivors are banked at max_length
    (None, 20, False),
    (1.0, 20, False),   # EOS ties EOS_TWIN exactly in every step
    (1.5, 20, False),   # EOS banked from inside the top beam: the pool at full width
    (3.0, 48, True),    # every element's pool fills: the search ends early
])
def test_beam_generate_matches_jax(tree, encoded, monkeypatch, factor, max_length, early):
    monkeypatch.setattr(port_model, "CHECK_EVERY", 8)
    steps = _count_steps(monkeypatch)
    got, want = _generate_both(_eos_tree(tree, factor), encoded, 5, max_length)
    np.testing.assert_array_equal(got, want)
    assert (len(steps) < max_length) == early


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_loss_matches_jax(tree, ctc_weight):
    """Label-smoothed CE, plus the CTC term on the ctc_head when weighted."""
    jax_cfg = JaxConfig.tiny(audio_feat_dim=104, ctc_loss_weight=ctc_weight)
    cfg = AVHubertConfig.tiny(audio_feat_dim=104, ctc_loss_weight=ctc_weight)
    jm, port = _pair(tree, jax_cfg, cfg)
    audio, video, lengths = _inputs(b=2, t=10)
    ids = np.random.default_rng(8).integers(3, CFG.vocab_size, (2, 4)).astype(np.int32)
    labels = ids.copy()
    labels[1, 3] = CFG.pad_token_id  # a padded label: masked in CE, shorter for CTC
    # jitted whole: op by op, JAX compiles each of the loss's ops on the CPU
    want = float(jax.jit(lambda *x: jm.loss(*x[:2], audio=x[2], video=x[3], lengths=x[4]))(
        ids, labels, audio, video, jnp.asarray(lengths)))
    got = float(port.loss(ids, labels, audio=audio, video=video, lengths=lengths))
    assert np.isfinite(got)
    assert abs(got - want) <= RTOL * abs(want)


def test_ctc_head_gradient(tree):
    _, port = _pair(tree)
    w = port.params["ctc_head"]["w"].requires_grad_(True)
    audio, _, lengths = _inputs(b=2, t=10)
    ids = np.random.default_rng(9).integers(3, CFG.vocab_size, (2, 4))
    port.loss(ids, ids, audio=audio, lengths=lengths).backward()
    assert torch.isfinite(w.grad).all()
    assert w.grad.abs().sum() > 0


def test_entry_points_need_the_gpu(monkeypatch, tree, tmp_path):
    """init() and from_pretrained() with no device mean CUDA, and raise
    without a GPU: no AVSR path carries on on the CPU."""
    from reazonspeech_tpu_torch.convert.store import save_param_tree

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for cls in (AVHubertForConditionalGeneration, AVHubertModel):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls.init(gen, CFG)
    save_param_tree(str(tmp_path / "tree"), tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AVHubertForConditionalGeneration.from_pretrained(str(tmp_path / "tree"))
    model = AVHubertForConditionalGeneration.init(gen, CFG, device="cpu")
    assert model.device == torch.device("cpu")
    assert model.params["dec_layers"]["ffn_in"]["w"].shape == (CFG.decoder_layers,
                                                               CFG.decoder_hidden_size,
                                                               CFG.decoder_ffn_dim)


def test_init_tree_layout_matches_jax(tree):
    """The port's init draws the JAX package's tree: the same keys, shapes
    and dtypes (the values differ: the generators differ)."""
    port = AVHubertForConditionalGeneration.init(torch.Generator().manual_seed(0), CFG,
                                                 device="cpu")

    def layout(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in layout(v, f"{prefix}{k}/").items()}
        if isinstance(t, list):
            return {k2: v2 for i, v in enumerate(t)
                    for k2, v2 in layout(v, f"{prefix}{i}/").items()}
        return {prefix: (tuple(t.shape), str(np.asarray(t).dtype) if not torch.is_tensor(t)
                         else str(t.dtype).replace("torch.", ""))}

    assert layout(port.params) == layout(tree)


def test_from_pretrained_native_tree_saved_by_jax(tree, tmp_path):
    """The JAX-initialised tree, saved by the JAX package's store and read
    back by the port, computes what the JAX model computes: the encoder,
    greedy and beam-5 tokens."""
    from reazonspeech_tpu.convert import store as jax_store

    path = str(tmp_path / "tree")
    jax_store.save_param_tree(path, tree, {"cfg": {f: getattr(JAX_CFG, f)
                                                   for f in JAX_CFG.__dataclass_fields__}})
    port = AVHubertForConditionalGeneration.from_pretrained(path, device="cpu")
    assert port.config == CFG
    jm, _ = _pair(tree)
    audio, video, lengths = _inputs()
    want, _ = jm.encoder(audio=audio, video=video, lengths=jnp.asarray(lengths))
    got, _ = port.encoder(audio=audio, video=video, lengths=lengths)
    assert rel(got, want) < RTOL
    for beams in (1, 5):
        want = np.asarray(jm.generate(audio=audio, video=video, lengths=jnp.asarray(lengths),
                                      num_beams=beams, max_length=8))
        got = port.generate(audio=audio, video=video, lengths=lengths, num_beams=beams,
                            max_length=8)
        np.testing.assert_array_equal(got.numpy(), want)
