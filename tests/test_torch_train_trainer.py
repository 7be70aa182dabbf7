"""The port's Trainer and training data against the JAX package's: the
warmup-cosine schedule value for value against optax's, manifest batches
equal to the JAX ``manifest_batches``', a Trainer that saves at step 2,
restores and goes on to step 4 bit-equal to an uninterrupted run to 4 (on
the CPU), the checkpoint retention and listing, and the refusals
(``mesh=`` with ``pipeline=``, a device off the mesh, no GPU without
``device="cpu"``, no checkpoint to restore)."""

import json
import os

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch.core.audio import AudioData, audio_to_file
from reazonspeech_tpu_torch.frontend.features import nemo_frontend_config
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
from reazonspeech_tpu_torch.nemo.asr.model import init_params
from reazonspeech_tpu_torch.training import Trainer, TrainerConfig, data as tdata
from reazonspeech_tpu_torch.training import warmup_cosine_decay_schedule
from reazonspeech_tpu_torch.training.train_step import tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 1e-3, 1000, 100_000, 5e-5),  # TrainerConfig's defaults
    (0.0, 1e-3, 1, 100, 5e-5),
    (1e-4, 2e-3, 7, 20, 0.0),
    (0.0, 5e-4, 0, 10, 1e-5),
])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    import optax

    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    got = warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    steps = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, decay // 2, decay - 1, decay,
                    decay + 5} - {-1}) + list(range(0, 40))
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=1e-12)


def test_trainer_schedule_is_the_configs():
    cfg = TrainerConfig(peak_lr=2e-3, warmup_steps=3, decay_steps=30, end_lr_scale=0.1)
    enc, rnnt = _tiny()
    tr = Trainer(nemo_frontend_config(), enc, rnnt, cfg, device="cpu")
    want = warmup_cosine_decay_schedule(0.0, 2e-3, 3, 30, 2e-4)
    assert [tr.schedule(s) for s in range(35)] == [want(s) for s in range(35)]


def _manifest(tmp_path, n=5):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = str(tmp_path / f"u{i}.wav")
        audio_to_file(path, AudioData(
            (rng.standard_normal(4000 + 3000 * i) * 0.1).astype(np.float32), 16000))
        rows.append({"audio": path, "transcription": "あいう" * (i + 1) if i != 2 else "?"})
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows),
                        encoding="utf-8")
    return str(manifest)


class _Tok:
    """Characters to ids; '?' is not in the vocabulary."""

    def text_to_ids(self, text):
        if "?" in text:
            raise ValueError(text)
        return [ord(c) % 50 + 1 for c in text]


@pytest.mark.parametrize("shuffle,epochs", [(True, 2), (False, 1)])
def test_manifest_batches_match_jax(tmp_path, shuffle, epochs):
    """The same batches as the JAX package's: order, refill of dropped rows,
    bucketed padding, lengths."""
    from reazonspeech_tpu.training import data as jdata

    manifest = _manifest(tmp_path)
    kw = dict(batch_size=2, samples_bucket=4000, label_bucket=4, epochs=epochs,
              shuffle=shuffle, seed=3)
    got = list(tdata.manifest_batches(manifest, _Tok(), **kw))
    want = list(jdata.manifest_batches(manifest, _Tok(), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert tdata.read_manifest(manifest) == jdata.read_manifest(manifest)
    assert [b["lengths"].tolist() for b in tdata.prefetch(iter(got))] == \
        [b["lengths"].tolist() for b in got]


def _tiny():
    enc = FastConformerConfig.tiny(d_model=64, num_heads=4, compute_dtype="float32",
                                   attn_impl="pallas", lnd_impl="pallas", conv_impl="xla")
    return enc, RNNTConfig.tiny(enc_dim=64, compute_dtype="float32")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"waveform": (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32),
            "lengths": np.array([8000, 6000], np.int32),
            "labels": rng.integers(1, 64, (2, 4)).astype(np.int32),
            "label_lengths": np.array([4, 3], np.int32)}


def test_resume_equals_continuation(tmp_path):
    """save at step 2, restore_latest, go on to 4: every leaf equal bit for
    bit to a run straight to 4, the history records and JSONL log as the
    JAX Trainer writes them, keep_checkpoints retention."""
    enc, rnnt = _tiny()
    params = init_params(0, enc, rnnt)
    batches = [_batch(i) for i in range(4)]
    cfg = TrainerConfig(checkpoint_dir=str(tmp_path / "ck"), save_every=1, log_every=1,
                        keep_checkpoints=2, warmup_steps=2, decay_steps=10, peak_lr=1e-3)
    fe = nemo_frontend_config()
    straight = Trainer(fe, enc, rnnt, TrainerConfig(**{**cfg.__dict__, "checkpoint_dir": None}),
                       device="cpu").init(params)
    h_straight = straight.fit(batches, max_steps=4)
    first = Trainer(fe, enc, rnnt, cfg, device="cpu").init(params)
    log = str(tmp_path / "log" / "train.jsonl")
    first.fit(batches[:2], max_steps=2, log_file=log)
    assert Trainer.list_checkpoints(cfg.checkpoint_dir) == [1, 2]
    resumed = Trainer(fe, enc, rnnt, cfg, device="cpu").restore_latest(params)
    assert resumed.state.step == 2
    h_resumed = resumed.fit(batches[2:], max_steps=4, log_file=log)
    assert resumed.state.step == 4
    assert Trainer.list_checkpoints(cfg.checkpoint_dir) == [3, 4]  # the newest two kept
    for a, b in zip(tree_leaves(straight.state.params), tree_leaves(resumed.state.params)):
        assert torch.equal(a, b)
    assert [r["loss"] for r in h_resumed] == [r["loss"] for r in h_straight[2:]]
    assert [r["step"] for r in h_straight] == [1, 2, 3, 4]
    assert all(set(r) == {"step", "loss", "grad_norm", "seconds"} for r in h_straight)
    lines = [json.loads(x) for x in open(log, encoding="utf-8")]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    # the fit stops at max_steps even with batches left
    more = resumed.fit(batches, max_steps=4)
    assert resumed.state.step == 4 and more == h_resumed


def test_log_every_and_save_every(tmp_path):
    enc, rnnt = _tiny()
    cfg = TrainerConfig(checkpoint_dir=str(tmp_path), save_every=3, log_every=2,
                        warmup_steps=1, decay_steps=10)
    tr = Trainer(nemo_frontend_config(), enc, rnnt, cfg, device="cpu")
    tr.init(init_params(1, enc, rnnt))
    hist = tr.fit([_batch(0)] * 4, max_steps=4)
    assert [r["step"] for r in hist] == [1, 2, 4]  # step 1 and every log_every
    assert Trainer.list_checkpoints(str(tmp_path)) == [3]
    assert os.path.isfile(tmp_path / "step_00000003" / "state.pt")


def test_refusals(tmp_path, monkeypatch):
    enc, rnnt = _tiny()
    fe = nemo_frontend_config()
    # mesh= and pipeline= train (tests/test_torch_parallel_mesh.py); both
    # at once, or a device other than the mesh's first entry, are refused
    from reazonspeech_tpu_torch.parallel import PipelineSpec, make_mesh, make_pipeline_mesh

    mesh = make_mesh(2, devices=["cpu"] * 2)
    spec = PipelineSpec(mesh=make_pipeline_mesh(2, devices=["cpu"] * 2))
    for kw in (dict(mesh=mesh, pipeline=spec), dict(mesh=mesh, device="cuda"),
               dict(pipeline=spec, device="meta")):
        with pytest.raises(ValueError):
            Trainer(fe, enc, rnnt, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(fe, enc, rnnt)
    tr = Trainer(fe, enc, rnnt, TrainerConfig(checkpoint_dir=str(tmp_path / "none")),
                 device="cpu")
    with pytest.raises(FileNotFoundError):
        tr.restore_latest(init_params(0, enc, rnnt))
    with pytest.raises(RuntimeError, match="init"):
        tr.fit([_batch(0)], max_steps=1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Trainer(fe, enc, rnnt, device="cpu").init(init_params(0, enc, rnnt)).save()
