"""The port's checkpoint converters against the JAX package's on the same
published-layout fixtures (``fixture_checkpoints.py``): the layout
transforms, the nemo ``.nemo`` archive, the espnet zoo directory (with and
without the RNN-T head, GlobalMVN in each stats layout), the icefall ``.pt``,
the sherpa snapshot in fp32, int8 and int8-fp32, the ONNX reader and
tokens.txt, and the int8 writer. The conversion is numpy transposes,
reshapes and folds, so every tree must be equal leaf by leaf: the same keys,
shapes and dtypes, and ``np.array_equal`` values; the metadata the loaders
read must be equal too."""

import io
import json
import os
import tarfile
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax

from reazonspeech_tpu.convert import espnet_conformer as j_espnet
from reazonspeech_tpu.convert import icefall_zipformer as j_icefall
from reazonspeech_tpu.convert import nemo_fastconformer as j_nemo
from reazonspeech_tpu.convert import onnx_reader as j_onnx
from reazonspeech_tpu.convert import onnx_zipformer as j_sherpa
from reazonspeech_tpu.convert import quantize as j_quant
from reazonspeech_tpu.convert import torch_utils as j_tu
from reazonspeech_tpu.models import conformer as j_conformer
from reazonspeech_tpu.models import fastconformer as j_fc
from reazonspeech_tpu.models import rnnt as j_rnnt
from reazonspeech_tpu.models import zipformer as j_zf
from reazonspeech_tpu_torch.convert import espnet_conformer as t_espnet
from reazonspeech_tpu_torch.convert import icefall_zipformer as t_icefall
from reazonspeech_tpu_torch.convert import nemo_fastconformer as t_nemo
from reazonspeech_tpu_torch.convert import onnx_reader as t_onnx
from reazonspeech_tpu_torch.convert import onnx_zipformer as t_sherpa
from reazonspeech_tpu_torch.convert import quantize as t_quant
from reazonspeech_tpu_torch.convert import torch_utils as t_tu
from reazonspeech_tpu_torch.convert.store import load_param_tree
from reazonspeech_tpu_torch.k2.asr.huggingface import hf_repo_files
from reazonspeech_tpu_torch.models import conformer as t_conformer
from reazonspeech_tpu_torch.models import fastconformer as t_fc
from reazonspeech_tpu_torch.models import rnnt as t_rnnt
from reazonspeech_tpu_torch.models import zipformer as t_zf

from fixture_checkpoints import (
    encode_varint,
    field,
    synth_icefall_state_dict,
    write_espnet_zoo,
    write_k2_repo,
    write_nemo_archive,
    write_onnx,
)

RNG = np.random.default_rng(12)


def rt(*shape):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


def flat(tree, prefix=""):
    """{path: leaf} of a dict/list tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def assert_same_tree(got, want):
    """The same keys, and at each key the same shape, dtype and values."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert g[k].dtype == w[k].dtype, k
        assert np.array_equal(g[k], w[k]), k


def assert_same_files(out_t, out_j):
    """The two stores' files hold the same tree and the same metadata."""
    tree_t, meta_t = load_param_tree(out_t)
    tree_j, meta_j = load_param_tree(out_j)
    assert_same_tree(tree_t, tree_j)
    for meta, out in ((meta_t, out_t), (meta_j, out_j)):
        if "tokenizer_model" in meta:  # a path beside each tree: compare the bytes
            assert meta["tokenizer_model"] == out + ".tokenizer.model"
            with open(meta.pop("tokenizer_model"), "rb") as f:
                meta["tokenizer_bytes"] = f.read()
    assert meta_t == meta_j
    return meta_t


# --- the layout transforms ----------------------------------------------------


TRANSFORMS = {
    "t_linear": lambda: (rt(7, 12), rt(7)),
    "t_linear_no_bias": lambda: (rt(7, 12),),
    "t_conv1d": lambda: (rt(10, 6, 5), rt(10)),
    "t_depthwise_conv1d": lambda: (rt(8, 1, 9), rt(8)),
    "t_conv2d": lambda: (rt(5, 3, 3, 3), rt(5)),
    "t_conv3d": lambda: (rt(4, 1, 5, 7, 7),),
    "t_lstm_layer": lambda: (rt(64, 12), rt(64, 16), rt(64), rt(64)),
    "t_batch_norm": lambda: (rt(6), rt(6), rt(6), rt(6).abs() + 0.5),
    "t_layer_norm": lambda: (rt(8), rt(8)),
    "t_flatten_proj": lambda: (rt(16, 4 * 9), rt(16), 4),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    args = TRANSFORMS[name]()
    fn = name.removesuffix("_no_bias")
    assert_same_tree(getattr(t_tu, fn)(*args), getattr(j_tu, fn)(*args))


def test_stack_trees_matches_jax_tree_map():
    """``stack_trees`` is the JAX converters' ``jax.tree.map(np.stack)``."""
    blocks = [{"a": {"w": RNG.standard_normal((3, 4)).astype(np.float32),
                     "b": np.float32(i)},
               "c": [RNG.standard_normal(2), np.asarray(i, np.int64)]} for i in range(3)]
    got = t_tu.stack_trees(blocks)
    assert_same_tree(got, jax.tree.map(lambda *xs: np.stack(xs), *blocks))
    assert got["a"]["w"].shape == (3, 3, 4)


# --- nemo ---------------------------------------------------------------------


def _nemo_configs():
    kw = dict(num_layers=3, d_model=64, num_heads=4, subsampling_channels=16)
    return (j_fc.FastConformerConfig.tiny(**kw), j_rnnt.RNNTConfig.tiny(enc_dim=64),
            t_fc.FastConformerConfig.tiny(**kw), t_rnnt.RNNTConfig.tiny(enc_dim=64))


@pytest.fixture(scope="module")
def nemo_archive(tmp_path_factory):
    """A .nemo archive with a tokenizer model appended, as published."""
    path = str(tmp_path_factory.mktemp("nemo") / "reazonspeech-nemo-v2.nemo")
    jenc, jr, _, _ = _nemo_configs()
    sd = write_nemo_archive(path, jenc, jr)
    tok = b"\n\x08\n\x03<unk>\x15\x00\x00\x00\x00\x18\x02"
    with tarfile.open(path, "a") as tar:
        info = tarfile.TarInfo("a1b2_tokenizer.model")
        info.size = len(tok)
        tar.addfile(info, io.BytesIO(tok))
    return path, sd


def test_nemo_archive_matches_jax(nemo_archive, tmp_path):
    path, _ = nemo_archive
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    params_t, enc_t, rnnt_t = t_nemo.convert_nemo_checkpoint(path, out_t)
    params_j, enc_j, rnnt_j = j_nemo.convert_nemo_checkpoint(path, out_j)
    assert_same_tree(params_t, params_j)
    assert asdict(enc_t) == asdict(enc_j) and asdict(rnnt_t) == asdict(rnnt_j)
    assert isinstance(enc_t, t_fc.FastConformerConfig) and isinstance(rnnt_t, t_rnnt.RNNTConfig)
    meta = assert_same_files(out_t, out_j)
    assert meta["decoding"]["strategy"] == "alsd" and meta["decoding"]["beam_size"] == 4
    assert meta["tokenizer_bytes"].startswith(b"\n\x08")


def test_nemo_read_and_configs_match_jax(nemo_archive):
    path, sd = nemo_archive
    state_t, config_t, tok_t = t_nemo.read_nemo_tar(path)
    state_j, config_j, tok_j = j_nemo.read_nemo_tar(path)
    assert config_t == config_j and tok_t == tok_j
    assert sorted(state_t) == sorted(sd)
    assert all(torch.equal(state_t[k], state_j[k]) for k in sd)
    enc_t, rnnt_t = t_nemo.infer_configs_from_nemo(config_t)
    enc_j, rnnt_j = j_nemo.infer_configs_from_nemo(config_j)
    assert asdict(enc_t) == asdict(enc_j) and asdict(rnnt_t) == asdict(rnnt_j)
    jenc, jr, _, _ = _nemo_configs()
    assert (enc_t.num_layers, enc_t.d_model, rnnt_t.vocab_size) == (
        jenc.num_layers, jenc.d_model, jr.vocab_size)


def test_nemo_state_dict_matches_jax(nemo_archive):
    """The state-dict converter alone, at configs passed in, and the tree
    has the port's init_params structure."""
    from reazonspeech_tpu_torch.nemo.asr.model import init_params

    _, sd = nemo_archive
    jenc, jr, tenc, tr = _nemo_configs()
    got = t_nemo.convert_nemo_state_dict(sd, tenc, tr)
    assert_same_tree(got, j_nemo.convert_nemo_state_dict(sd, jenc, jr))
    template = init_params(0, tenc, tr)
    assert {k: v.shape for k, v in flat(got).items()} == {
        k: tuple(v.shape) for k, v in flat(template).items()}


def test_nemo_archive_without_weights_raises(tmp_path):
    path = str(tmp_path / "empty.nemo")
    with tarfile.open(path, "w"):
        pass
    for mod in (t_nemo, j_nemo):
        with pytest.raises(ValueError, match="model_weights.ckpt not found"):
            mod.read_nemo_tar(path)


# --- espnet -------------------------------------------------------------------


ESPNET_TOKENS = ["<blank>"] + list("あいうえおかきくけこ") + ["<sos/eos>"]
ESPNET_ENC = dict(num_layers=2, d_model=32, num_heads=4, subsampling_channels=32)


def _espnet_rnnt(mod):
    return mod.RNNTConfig(vocab_size=len(ESPNET_TOKENS), enc_dim=32, pred_hidden=16,
                          joint_hidden=24, joint_activation="tanh", blank_position="first")


@pytest.mark.parametrize("head", ["rnnt", "ctc_only"])
def test_espnet_zoo_matches_jax(tmp_path, head):
    jenc = j_conformer.espnet_encoder_config(**ESPNET_ENC)
    rnnt = _espnet_rnnt(j_rnnt) if head == "rnnt" else None
    write_espnet_zoo(str(tmp_path / "zoo"), jenc, ESPNET_TOKENS, rnnt)
    run = tmp_path / "zoo" / "exp" / "asr_train_asr_conformer_raw_jp_char"
    pth, cfg = str(run / "valid.acc.ave_10best.pth"), str(run / "config.yaml")
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    params_t, enc_t = t_espnet.convert_espnet_checkpoint(pth, out_t, config_yaml=cfg)
    params_j, enc_j = j_espnet.convert_espnet_checkpoint(pth, out_j, config_yaml=cfg)
    assert_same_tree(params_t, params_j)
    assert asdict(enc_t) == asdict(enc_j)
    assert isinstance(enc_t, t_fc.FastConformerConfig)
    meta = assert_same_files(out_t, out_j)
    assert meta["token_list"] == ESPNET_TOKENS and meta["normalize"] == "global_mvn"
    assert ("rnnt_cfg" in meta) == (head == "rnnt")
    assert ("predictor" in params_t) == (head == "rnnt")
    assert params_t["normalize"]["mean"].shape == (jenc.feat_in,)


def test_espnet_state_dict_without_config_matches_jax(tmp_path):
    """No config.yaml: the preset's config, no token list, no GlobalMVN."""
    from fixture_checkpoints import synth_espnet_state_dict

    jenc = j_conformer.espnet_encoder_config(num_layers=2, d_model=32, num_heads=4,
                                             subsampling_channels=8)
    sd = synth_espnet_state_dict(jenc, len(ESPNET_TOKENS), _espnet_rnnt(j_rnnt))
    tenc = t_conformer.espnet_encoder_config(num_layers=2, d_model=32, num_heads=4,
                                             subsampling_channels=8)
    assert_same_tree(t_espnet.convert_espnet_state_dict(sd, tenc),
                     j_espnet.convert_espnet_state_dict(sd, jenc))
    pth = str(tmp_path / "model.pth")
    torch.save(sd, pth)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    t_espnet.convert_espnet_checkpoint(pth, out_t, enc_cfg=tenc)
    j_espnet.convert_espnet_checkpoint(pth, out_j, enc_cfg=jenc)
    meta = assert_same_files(out_t, out_j)
    assert "token_list" not in meta and "normalize" not in meta


def _stats_files(base, layout, feat):
    """Write one GlobalMVN stats file of ``layout``; return the path to record."""
    rng = np.random.default_rng(3)
    mean, var = rng.normal(-4.0, 1.0, feat), rng.uniform(2.0, 6.0, feat)
    if layout == "count_sum":
        path = os.path.join(base, "feats_stats.npz")
        np.savez(path, count=np.array([500.0]), sum=mean * 500.0,
                 sum_square=(var + mean * mean) * 500.0)
        return "/training/machine/feats_stats.npz"  # found by its basename
    if layout == "mean_std":
        path = os.path.join(base, "global_stats.npz")
        np.savez(path, mean=mean, std=np.sqrt(var))
        return None  # found by the glob next to the config
    path = os.path.join(base, "legacy.npy")  # [2, D+1]: sums and the count
    np.save(path, np.stack([np.append(mean * 500.0, 500.0),
                            np.append((var + mean * mean) * 500.0, 0.0)]))
    return path


@pytest.mark.parametrize("layout", ["count_sum", "mean_std", "legacy", "missing", "off"])
def test_global_mvn_stats_match_jax(tmp_path, layout):
    import yaml

    conf = {"normalize": "utterance_mvn" if layout == "off" else "global_mvn"}
    if layout not in ("missing", "off"):
        rec = _stats_files(str(tmp_path), layout, 80)
        if rec:
            conf["normalize_conf"] = {"stats_file": rec}
    cfg = str(tmp_path / "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(conf, f)
    if layout == "missing":
        for mod in (t_espnet, j_espnet):
            with pytest.raises(FileNotFoundError, match="global_mvn"):
                mod.load_global_mvn_stats(cfg)
        return
    got, want = t_espnet.load_global_mvn_stats(cfg), j_espnet.load_global_mvn_stats(cfg)
    if layout == "off":
        assert got is None and want is None
        return
    assert_same_tree(got, want)
    assert got["mean"].shape == (80,) and got["std"].dtype == np.float32


def test_espnet_config_readers_match_jax(tmp_path):
    jenc = j_conformer.espnet_encoder_config(**ESPNET_ENC)
    write_espnet_zoo(str(tmp_path), jenc, ESPNET_TOKENS)
    cfg = str(tmp_path / "exp" / "asr_train_asr_conformer_raw_jp_char" / "config.yaml")
    tokens_t, conf_t = t_espnet.read_espnet_config(cfg)
    assert (tokens_t, conf_t) == j_espnet.read_espnet_config(cfg)
    enc_t = t_espnet.infer_config_from_espnet(conf_t)
    assert asdict(enc_t) == asdict(j_espnet.infer_config_from_espnet(conf_t))
    assert (enc_t.d_model, enc_t.subsampling_channels, enc_t.num_layers) == (32, 32, 2)


# --- k2: the icefall .pt and the sherpa snapshot ------------------------------


K2_TOKENS = ["<blk>", "<sos/eos>", "<unk>"] + list("あいうえおかきくけこ")


def _k2_rnnt(mod, enc_cfg):
    return mod.RNNTConfig(vocab_size=len(K2_TOKENS), enc_dim=enc_cfg.out_dim, pred_hidden=16,
                          joint_hidden=24, joint_activation="tanh",
                          predictor_kind="stateless", context_size=2)


@pytest.fixture(scope="module")
def icefall_sd():
    jenc = j_zf.ZipformerConfig.tiny()
    return synth_icefall_state_dict(jenc, _k2_rnnt(j_rnnt, jenc))


@pytest.mark.parametrize("wrapped", [True, False])
def test_icefall_checkpoint_matches_jax(icefall_sd, tmp_path, wrapped):
    """icefall's ``{"model": sd}`` and a bare state dict; the transducer dims
    come from the checkpoint itself."""
    pt = str(tmp_path / "pretrained.pt")
    torch.save({"model": icefall_sd} if wrapped else icefall_sd, pt)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    params_t, enc_t = t_icefall.convert_icefall_checkpoint(
        pt, out_t, enc_cfg=t_zf.ZipformerConfig.tiny(), token_list=K2_TOKENS)
    params_j, enc_j = j_icefall.convert_icefall_checkpoint(
        pt, out_j, enc_cfg=j_zf.ZipformerConfig.tiny(), token_list=K2_TOKENS)
    assert_same_tree(params_t, params_j)
    assert asdict(enc_t) == asdict(enc_j)
    meta = assert_same_files(out_t, out_j)
    assert meta["rnnt_cfg"]["predictor_kind"] == "stateless"
    assert meta["token_list"] == K2_TOKENS


def test_icefall_state_dict_has_init_structure(icefall_sd):
    tenc = t_zf.ZipformerConfig.tiny()
    got = t_icefall.convert_icefall_state_dict(icefall_sd, tenc, _k2_rnnt(t_rnnt, tenc))
    want = j_icefall.convert_icefall_state_dict(
        icefall_sd, j_zf.ZipformerConfig.tiny(), _k2_rnnt(j_rnnt, j_zf.ZipformerConfig.tiny()))
    assert_same_tree(got, want)
    template = t_zf.init_zipformer(torch.Generator().manual_seed(0), tenc, "cpu")
    assert {k: v.shape for k, v in flat(got["encoder"]).items()} == {
        k: tuple(v.shape) for k, v in flat(template).items()}


def test_icefall_wrong_embed_raises(icefall_sd):
    sd = {k: v for k, v in icefall_sd.items() if not k.startswith("encoder_embed.conv.8")}
    for mod, zf in ((t_icefall, t_zf), (j_icefall, j_zf)):
        with pytest.raises(ValueError, match="expected 3 embed convs"):
            mod.convert_icefall_state_dict(sd, zf.ZipformerConfig.tiny())


def _sherpa_repo(base, icefall_sd, precision):
    """A sherpa-style repo holding the fp32 and int8 graphs (one state dict);
    returns the files of ``precision``."""
    jenc = j_zf.ZipformerConfig.tiny()
    rnnt = _k2_rnnt(j_rnnt, jenc)
    write_k2_repo(base, jenc, rnnt, K2_TOKENS, sd=icefall_sd)
    write_k2_repo(base, jenc, rnnt, K2_TOKENS, int8=True, with_pt=False, sd=icefall_sd)
    files = hf_repo_files(precision, 99)
    return {k: os.path.join(base, v) for k, v in files.items()}


@pytest.mark.parametrize("precision", ["fp32", "int8", "int8-fp32"])
def test_sherpa_snapshot_matches_jax(icefall_sd, tmp_path, precision):
    f = _sherpa_repo(str(tmp_path / "repo"), icefall_sd, precision)
    pt = str(tmp_path / "repo" / "exp" / "pretrained.pt")
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    args = (f["encoder"], f["decoder"], f["joiner"])
    params_t, enc_t, rnnt_t = t_sherpa.convert_sherpa_snapshot(
        *args, out_t, tokens_txt=f["tokens"], icefall_pt=pt, enc_cfg=t_zf.ZipformerConfig.tiny())
    params_j, enc_j, rnnt_j = j_sherpa.convert_sherpa_snapshot(
        *args, out_j, tokens_txt=f["tokens"], icefall_pt=pt, enc_cfg=j_zf.ZipformerConfig.tiny())
    assert_same_tree(params_t, params_j)
    assert asdict(enc_t) == asdict(enc_j) and asdict(rnnt_t) == asdict(rnnt_j)
    meta = assert_same_files(out_t, out_j)
    assert meta["token_list"] == K2_TOKENS
    w = params_t["joint"]["out"]["w"]
    ref = icefall_sd["joiner.output_linear.weight"].numpy().T
    if precision == "fp32":
        assert np.array_equal(w, ref)
    else:  # the published int8 joiner, dequantized
        assert not np.array_equal(w, ref) and np.abs(w - ref).max() <= np.abs(ref).max() / 100


def test_sherpa_snapshot_needs_the_icefall_pt(icefall_sd, tmp_path):
    f = _sherpa_repo(str(tmp_path / "repo"), icefall_sd, "fp32")
    args = (f["encoder"], f["decoder"], f["joiner"], str(tmp_path / "out"))
    errors = []
    for mod, zf in ((t_sherpa, t_zf), (j_sherpa, j_zf)):
        with pytest.raises(FileNotFoundError, match="icefall") as err:
            mod.convert_sherpa_snapshot(*args, tokens_txt=f["tokens"],
                                        enc_cfg=zf.ZipformerConfig.tiny())
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_sherpa_token_count_mismatch_raises(icefall_sd, tmp_path):
    f = _sherpa_repo(str(tmp_path / "repo"), icefall_sd, "fp32")
    with open(f["tokens"], "a", encoding="utf-8") as fh:
        fh.write(f"extra {len(K2_TOKENS)}\n")
    for mod, zf in ((t_sherpa, t_zf), (j_sherpa, j_zf)):
        with pytest.raises(ValueError, match="tokens.txt has"):
            mod.convert_sherpa_snapshot(f["encoder"], f["decoder"], f["joiner"],
                                        str(tmp_path / "out"), tokens_txt=f["tokens"],
                                        enc_cfg=zf.ZipformerConfig.tiny())


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_decoder_joiner_match_jax(icefall_sd, tmp_path, precision):
    """The shape-driven decoder/joiner identification and the rnnt config
    inferred from the graphs."""
    f = _sherpa_repo(str(tmp_path / "repo"), icefall_sd, precision)
    out_dim = j_zf.ZipformerConfig.tiny().out_dim
    rnnt_t = t_sherpa.infer_rnnt_cfg_from_onnx(f["decoder"], f["joiner"], out_dim)
    rnnt_j = j_sherpa.infer_rnnt_cfg_from_onnx(f["decoder"], f["joiner"], out_dim)
    assert asdict(rnnt_t) == asdict(rnnt_j)
    assert isinstance(rnnt_t, t_rnnt.RNNTConfig)
    got = t_sherpa.convert_decoder_joiner(f["decoder"], f["joiner"], rnnt_t)
    want = j_sherpa.convert_decoder_joiner(f["decoder"], f["joiner"], rnnt_j)
    assert_same_tree(list(got), list(want))


def test_decoder_conversion_rejects_wrong_shapes(tmp_path):
    write_onnx(str(tmp_path / "d.onnx"), {"bogus": np.zeros((3, 3), np.float32)})
    write_onnx(str(tmp_path / "j.onnx"), {"bogus": np.zeros((3, 3), np.float32)})
    for mod in (t_rnnt, j_rnnt):
        cfg = mod.RNNTConfig(vocab_size=10, pred_hidden=8, predictor_kind="stateless",
                             context_size=2)
        conv = t_sherpa if mod is t_rnnt else j_sherpa
        with pytest.raises(ValueError, match="decoder graph tensors"):
            conv.convert_decoder_joiner(str(tmp_path / "d.onnx"), str(tmp_path / "j.onnx"), cfg)


def test_convert_zipformer_torch_delegates(icefall_sd, tmp_path):
    pt = str(tmp_path / "pretrained.pt")
    torch.save({"model": icefall_sd}, pt)
    got, _ = t_sherpa.convert_zipformer_torch(pt, str(tmp_path / "port"),
                                              enc_cfg=t_zf.ZipformerConfig.tiny())
    want, _ = j_sherpa.convert_zipformer_torch(pt, str(tmp_path / "jax"),
                                               enc_cfg=j_zf.ZipformerConfig.tiny())
    assert_same_tree(got, want)


# --- the ONNX reader and tokens.txt -------------------------------------------


def test_onnx_reader_matches_jax(tmp_path):
    """``write_onnx`` initializers of fp32, int8 and int64, and a 0-d scale."""
    tensors = {"w": RNG.standard_normal((3, 4)).astype(np.float32),
               "w_quantized": np.array([[1, -2], [3, -127]], np.int8),
               "w_scale": np.float32(0.25),
               "shape": np.array([2, 5, 7], np.int64)}
    path = str(tmp_path / "m.onnx")
    write_onnx(path, tensors)
    got = t_onnx.read_onnx_initializers(path)
    assert_same_tree(got, j_onnx.read_onnx_initializers(path))
    # a 0-d tensor has no dims on the wire: it reads back as one element
    assert_same_tree(got, dict(tensors, w_scale=np.array([0.25], np.float32)))


def test_onnx_reader_typed_fields_match_jax(tmp_path):
    """Initializers in the typed fields (float_data, int64_data, int32_data)
    instead of raw bytes, and one of a type the reader skips."""
    f = np.array([1.5, -2.0, 3.25], "<f4")
    i64 = np.array([7, -8], "<i8")
    i32 = np.array([5, 6, -1, 0], "<i4")

    def tensor(name, dtype, dims, payload):
        body = b"".join(field(1, 0, encode_varint(d)) for d in dims)
        return body + field(2, 0, encode_varint(dtype)) + field(8, 2, name.encode()) + payload

    graph = b"".join(field(5, 2, t) for t in (
        tensor("f", 1, [3], field(4, 2, f.tobytes())),
        tensor("i64", 7, [2], field(7, 2, i64.tobytes())),
        tensor("i32", 6, [2, 2], field(5, 2, i32.tobytes())),
        tensor("str", 8, [1], b""),
    ))
    path = tmp_path / "typed.onnx"
    path.write_bytes(field(7, 2, graph))
    got = t_onnx.read_onnx_initializers(str(path))
    assert_same_tree(got, j_onnx.read_onnx_initializers(str(path)))
    assert sorted(got) == ["f", "i32", "i64"] and got["i32"].shape == (2, 2)


def test_tokens_txt_matches_jax(tmp_path):
    path = tmp_path / "tokens.txt"
    path.write_text("".join(f"{t} {i}\n" for i, t in enumerate(K2_TOKENS)) + "\n",
                    encoding="utf-8")
    assert t_sherpa.read_tokens_txt(str(path)) == j_sherpa.read_tokens_txt(str(path)) == K2_TOKENS
    path.write_text("<blk> 0\nあ 2\n", encoding="utf-8")
    for mod in (t_sherpa, j_sherpa):
        with pytest.raises(ValueError, match="not contiguous"):
            mod.read_tokens_txt(str(path))


# --- the int8 writer ----------------------------------------------------------


def _quant_cases():
    rng = np.random.default_rng(5)
    return {
        "dense": {"w": rng.standard_normal((128, 256)).astype(np.float32),
                  "b": rng.standard_normal(256).astype(np.float32)},
        "stacked": {"blocks": {"w": rng.standard_normal((3, 64, 96)).astype(np.float32)},
                    "lstm": [{"w_ih": rng.standard_normal((64, 128)).astype(np.float32)}]},
        "small_and_typed": {"tiny": rng.standard_normal((8, 8)).astype(np.float32),
                            "f64": rng.standard_normal((128, 64)),
                            "zero_col": np.zeros((64, 80), np.float32)},
    }


@pytest.mark.parametrize("case", sorted(_quant_cases()))
def test_quantize_tree_matches_jax(case, tmp_path):
    tree = _quant_cases()[case]
    got, want = t_quant.quantize_tree(tree), j_quant.quantize_tree(tree)
    assert_same_tree(got, want)
    assert t_quant.is_quantized(got) and j_quant.is_quantized(want)
    if case == "small_and_typed":  # too small, or not fp32: left as they were
        assert np.array_equal(got["tiny"], tree["tiny"]) and got["f64"].dtype == np.float64
    # the round trip through the port's reading half, and through its store
    assert_same_tree(t_quant.dequantize_tree(got), j_quant.dequantize_tree(want))
    from reazonspeech_tpu_torch.convert.store import save_param_tree

    save_param_tree(str(tmp_path / "q"), got, {"precision": "int8"})
    loaded, meta = load_param_tree(str(tmp_path / "q"))
    assert meta == {"precision": "int8"}
    assert_same_tree(t_quant.dequantize_tree(loaded), j_quant.dequantize_tree(want))


def test_quantized_sherpa_tree_matches_jax(icefall_sd, tmp_path):
    """The int8 writer on a converted k2 tree: equal int8 trees, and the
    dequantized weights within int8 error of the fp32 ones."""
    f = _sherpa_repo(str(tmp_path / "repo"), icefall_sd, "fp32")
    pt = str(tmp_path / "repo" / "exp" / "pretrained.pt")
    params, _, _ = t_sherpa.convert_sherpa_snapshot(
        f["encoder"], f["decoder"], f["joiner"], str(tmp_path / "out"), tokens_txt=f["tokens"],
        icefall_pt=pt, enc_cfg=t_zf.ZipformerConfig.tiny())
    got, want = t_quant.quantize_tree(params), j_quant.quantize_tree(params)
    assert_same_tree(got, want)
    assert t_quant.is_quantized(got)
    back = t_quant.dequantize_tree(got)
    for k, v in flat(params).items():
        err = np.abs(flat(back)[k] - v).max() if v.size else 0.0
        assert err <= np.abs(v).max(initial=0.0) / 127.0 * 0.5 + 1e-7, k


def test_saved_trees_load_in_both_stores(nemo_archive, tmp_path):
    """The port's converted tree on disk is the format the JAX store reads."""
    from reazonspeech_tpu.convert.store import load_param_tree as j_load

    path, _ = nemo_archive
    out = str(tmp_path / "port")
    params, _, _ = t_nemo.convert_nemo_checkpoint(path, out)
    tree, meta = j_load(out)
    assert_same_tree(jax.tree.map(np.asarray, tree), params)
    with open(out + ".json") as f:
        assert json.load(f)["meta"] == meta
