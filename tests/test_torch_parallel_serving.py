"""The port's data-parallel serving over a single-process mesh of ``cpu``
entries, after ``tests/test_mesh_serving.py`` and
``tests/test_continuous_serving.py``: ``DataParallelDecoder`` against the JAX
package's on its emulated 4 x 2 mesh row for row and against the port's own
single-device ``decode_batch`` bit for bit (an 8-row batch of mixed lengths,
a 3-row batch that does not divide, ``decode_single``), on the nemo, espnet
and k2 containers; ``MicroBatcher`` and ``transcribe_batch`` over it;
``evaluation.mesh_model``; a shard's failure failing the call;
``ContinuousBatcher(mesh=4 entries)`` answering as the single-device pool,
and its refusals; ``reazonspeech-serve --mesh-data 2 --continuous``
building a two-entry mesh (the CUDA device list stubbed) and serving."""

import http.client
import json
import threading
from dataclasses import replace
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from reazonspeech_tpu.decoding.rnnt_beam import BeamDecodeConfig as JBeam
from reazonspeech_tpu.frontend.features import nemo_frontend_config as j_fe
from reazonspeech_tpu.models.fastconformer import FastConformerConfig as JEnc
from reazonspeech_tpu.models.rnnt import RNNTConfig as JRnnt
from reazonspeech_tpu.nemo.asr.model import NemoTPUModel, default_ja_tokenizer
from reazonspeech_tpu.parallel import DataParallelDecoder as JaxDataParallelDecoder
from reazonspeech_tpu.parallel import make_mesh as jax_make_mesh
from reazonspeech_tpu_torch.convert.from_jax import params_from_numpy
from reazonspeech_tpu_torch.core.audio import audio_from_numpy
from reazonspeech_tpu_torch.espnet.asr.model import load_model_container as load_espnet
from reazonspeech_tpu_torch.evaluation import mesh_model
from reazonspeech_tpu_torch.k2.asr.model import load_model_container as load_k2
from reazonspeech_tpu_torch.models.conformer import espnet_encoder_config
from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig as TEnc
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig as TRnnt
from reazonspeech_tpu_torch.models.zipformer import ZipformerConfig
from reazonspeech_tpu_torch.nemo.asr import transcribe_batch
from reazonspeech_tpu_torch.nemo.asr.model import load_model as load_nemo
from reazonspeech_tpu_torch.parallel import DataParallelDecoder, make_mesh
from reazonspeech_tpu_torch.parallel import mesh as tmesh
from reazonspeech_tpu_torch.serving import ContinuousBatcher, MicroBatcher
from reazonspeech_tpu_torch.serving import http as port_http

from test_torch_parity import randomize_norm_stats

SR = 16000
CPU = torch.device("cpu")
ENC = dict(num_layers=2, d_model=32, num_heads=4, ff_expansion=2, conv_kernel=9,
           subsampling_channels=32, compute_dtype="float32")
RNNT = dict(vocab_size=64, enc_dim=32, pred_hidden=32, joint_hidden=32, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: every mesh entry's worker
    and executor thread starts an OpenMP team of its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_data, n_model=1):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


@pytest.fixture(scope="module")
def nemo_pair():
    """(JAX container, port container) on one tree: ALSD beam 2, fp32."""
    from reazonspeech_tpu.nemo.asr.model import init_params

    jenc, jr = JEnc(**ENC), JRnnt(**RNNT)
    tree = randomize_norm_stats(jax.tree.map(np.asarray, init_params(0, jenc, jr)), seed=1)
    jmodel = NemoTPUModel(params=jax.tree.map(jax.numpy.asarray, tree), fe_cfg=j_fe(),
                          enc_cfg=jenc, rnnt_cfg=jr, decode_cfg=JBeam(beam_size=2),
                          tokenizer=default_ja_tokenizer(64))
    tmodel = load_nemo("cpu", checkpoint="random", enc_cfg=TEnc(**ENC), rnnt_cfg=TRnnt(**RNNT),
                       beam_size=2)
    return jmodel, replace(tmodel, params=params_from_numpy(tree))


@pytest.fixture(scope="module")
def others():
    """The espnet (Graves beam 4, its joint's blank raised) and k2 (greedy)
    containers, tiny, fp32."""
    espnet = load_espnet(checkpoint="random", device="cpu", decoding="beam", beam_size=4,
                         enc_cfg=espnet_encoder_config(num_layers=2, d_model=32, num_heads=4,
                                                       subsampling_channels=32,
                                                       compute_dtype="float32"))
    espnet.params["joint"]["out"]["b"][0] += 2.5
    k2 = load_k2(checkpoint="random", device="cpu",
                 enc_cfg=ZipformerConfig.tiny(compute_dtype="float32"))
    return {"espnet": espnet, "k2": k2}


def _mixed_wavs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(SR * rng.choice((0.5, 1.2, 2.3, 3.1)))) * 0.1)
            .astype(np.float32) for _ in range(n)]


def _padded(wavs, bucket):
    n = -(-max(len(w) for w in wavs) // bucket) * bucket
    buf = np.zeros((len(wavs), n), np.float32)
    lens = np.zeros(len(wavs), np.int32)
    for i, w in enumerate(wavs):
        buf[i, :len(w)] = w
        lens[i] = len(w)
    return buf, lens


@pytest.mark.parametrize("rows", [8, 3])
def test_dp_decode_matches_jax_and_single_device(nemo_pair, rows):
    """8 rows over 4 data entries (two each) and 3 rows padded to 4: row
    for row equal to JAX's DataParallelDecoder on its 4 x 2 mesh and, bit
    for bit, to the port's own decode_batch of the same rows."""
    jmodel, tmodel = nemo_pair
    buf, lens = _padded(_mixed_wavs(rows, seed=rows), tmodel.bucket_samples)
    dp = DataParallelDecoder(tmodel, _mesh(4, 2))
    try:
        got = dp.decode_batch(buf, lens)
    finally:
        dp.close()
    want = JaxDataParallelDecoder(jmodel, jax_make_mesh(n_data=4, n_model=2)).decode_batch(
        buf, lens)
    single = tmodel.decode_batch(buf, lens)
    assert len(got) == len(want) == len(single) == 4
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("flavor", ["espnet", "k2"])
def test_dp_decode_other_flavors(others, flavor):
    """espnet's five outputs (the saturation flags through its host post)
    and k2's four, each shard's rows equal to the container's own decode of
    those rows."""
    model = others[flavor]
    buf, lens = _padded(_mixed_wavs(4, seed=21), model.bucket_samples)
    dp = DataParallelDecoder(model, _mesh(2))
    try:
        got = dp.decode_batch(buf, lens)
    finally:
        dp.close()
    assert len(got) == (5 if flavor == "espnet" else 4)
    for d in range(2):
        want = model.decode_batch(buf[2 * d:2 * d + 2], lens[2 * d:2 * d + 2])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2 * d:2 * d + 2], w)


def test_dp_decode_single_and_transcribe_batch(nemo_pair):
    _, tmodel = nemo_pair
    dp = DataParallelDecoder(tmodel, _mesh(4))
    try:
        w = _mixed_wavs(1, seed=5)[0]
        assert dp.decode_single(w) == tmodel.decode_single(w)
        # attribute delegation: the flavor's public entry point runs over the mesh
        audios = [audio_from_numpy(x, SR) for x in _mixed_wavs(5, seed=17)]
        got, want = transcribe_batch(dp, audios), transcribe_batch(tmodel, audios)
        assert [r.text for r in got] == [r.text for r in want]
        assert [[s.seconds for s in r.subwords] for r in got] == \
            [[s.seconds for s in r.subwords] for r in want]
        assert dp.tokenizer is tmodel.tokenizer and dp.batch_multiple == 4
    finally:
        dp.close()


def test_microbatcher_over_mesh(nemo_pair):
    """Batch buckets rounded to the data axis; every request equal to its
    dedicated decode; a max_batch that does not divide refused."""
    _, tmodel = nemo_pair
    dp = DataParallelDecoder(tmodel, _mesh(4))
    batcher = MicroBatcher(dp, max_batch=8, max_wait_ms=40.0)
    try:
        wavs = _mixed_wavs(6, seed=9)
        got = [f.result(timeout=300) for f in [batcher.submit(w) for w in wavs]]
    finally:
        batcher.close()
        dp.close()
    for w, (tokens, frames) in zip(wavs, got):
        assert (tokens, frames) == tmodel.decode_single(w)
    assert all(b % 4 == 0 for b, _ in batcher.batch_shapes)
    with pytest.raises(ValueError):
        MicroBatcher(dp, max_batch=6)


def test_mesh_model_and_a_failing_shard(nemo_pair):
    _, tmodel = nemo_pair
    wrapped = mesh_model(tmodel, 2, devices=[CPU, CPU])
    try:
        assert isinstance(wrapped, DataParallelDecoder) and wrapped.n_data == 2
        w = _mixed_wavs(1, seed=3)[0]
        assert wrapped.decode_single(w) == tmodel.decode_single(w)

        def fail(params, wav, lens):  # one shard of the two fails
            if int(lens.max()) == 0:
                raise RuntimeError("shard failed")
            return tmodel.decode_batch_fn()(params, wav, lens)

        wrapped._fn = fail
        with pytest.raises(RuntimeError, match="shard failed"):
            wrapped.decode_single(w)
    finally:
        wrapped.close()
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh_model(tmodel, 2, devices=[CPU])
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        mesh_model(tmodel, 2)  # the visible CUDA devices: none here


def test_continuous_batcher_over_mesh_matches_single_device(nemo_pair, others):
    """The lane pool split into four groups of one lane (each with its own
    params, state and ring on its entry): every request's answer equals the
    single-device pool's, for ALSD (nemo) and Graves (espnet)."""
    for model in (nemo_pair[1], others["espnet"]):
        wavs = _mixed_wavs(6, seed=13)
        kw = dict(n_lanes=4, frames_per_segment=8, max_seconds=4.0, max_encode_batch=4)
        single = ContinuousBatcher(model, **kw)
        try:
            want = [f.result(timeout=300) for f in [single.submit(w) for w in wavs]]
        finally:
            single.close()
        sharded = ContinuousBatcher(model, mesh=_mesh(4), **kw)
        try:
            assert [(g.lo, g.hi) for g in sharded._groups] == [(0, 1), (1, 2), (2, 3), (3, 4)]
            got = [f.result(timeout=300) for f in [sharded.submit(w) for w in wavs]]
        finally:
            sharded.close()
        assert got == want, type(model).__name__
        assert sharded.requests_done == len(wavs)


def test_continuous_batcher_mesh_refusals(others):
    model = others["espnet"]
    with pytest.raises(ValueError, match="n_lanes=3 must divide"):
        ContinuousBatcher(model, n_lanes=3, mesh=_mesh(4))
    with pytest.raises(ValueError, match="max_encode_batch=6 must divide"):
        ContinuousBatcher(model, n_lanes=4, max_encode_batch=6, mesh=_mesh(4))


def test_http_mesh_data_serves_over_two_entries(nemo_pair, monkeypatch, capsys):
    """--mesh-data 2 --continuous: a mesh over the first two CUDA devices
    (the device list stubbed to two CPU entries), the executor's pool split
    in two, a request answered."""
    _, tmodel = nemo_pair
    monkeypatch.setattr(tmesh, "cuda_devices", lambda: [CPU, CPU, CPU])
    monkeypatch.setattr(port_http, "_load_flavor", lambda *a, **k: tmodel)
    answers = []

    def serve_once(handler, batcher, host, port):
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
            conn.request("POST", "/transcribe", _mixed_wavs(1, seed=2)[0].tobytes(),
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            answers.append((resp.status, json.loads(resp.read()), batcher))
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
            batcher.close()

    monkeypatch.setattr(port_http, "_serve_until_shutdown", serve_once)
    port_http.main(["--checkpoint", "random", "--continuous", "--mesh-data", "2",
                    "--lanes", "4", "--max-seconds", "4"])
    (status, payload, batcher), = answers
    assert status == 200 and "text" in payload
    assert batcher.mesh.shape == {"data": 2, "model": 1}
    assert [(g.lo, g.hi) for g in batcher._groups] == [(0, 2), (2, 4)]
    assert "mesh: Mesh({'data': 2, 'model': 1}" in capsys.readouterr().out


def test_launch_counts_survive_concurrent_entries(monkeypatch):
    """Mesh entries launch from threads of their own: the per-kernel launch
    counts (which the smoke's path checks read) lose no launch when many
    threads count at once (a fake library stands in for the CUDA one)."""
    import sys

    from reazonspeech_tpu_torch import ops
    from reazonspeech_tpu_torch.ops import _kernels

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_kernels, "load_library", lambda: _Lib())
    ops.reset_launch_counts()
    n_threads, n_calls = 8, 3000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels.launch("rs_ln_dense")
                                                    for _ in range(n_calls)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ops.launch_counts()["ln_dense"] == n_threads * n_calls
    ops.reset_launch_counts()
