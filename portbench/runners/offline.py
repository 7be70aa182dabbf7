"""Offline traffic: batches of equal chunks transcribed back to back.

The mix's file gives ``batch`` (utterances a call), ``chunk_seconds``,
``distinct_batches`` (batches made from the seed and taken in turn) and
``sample`` (utterances the reference checks, drawn from the seed over the
distinct batches before the window). The chunks are speech-like noise made
from the seed on the device in one call (:func:`stage`); all are staged in
host memory, as the program's input type, before the window.

Every call of the window leaves what ``correct`` judges: the served
(tokens, frames) of each utterance, and the encoder output of the sampled
rows of its batch, copied on the device as the call runs (one
``index_select`` a call, kept until the window has closed).

``--trace 0``: the window calls the program's ``transcribe_batch`` until
``seconds`` have passed, and ``rtfx`` is the audio seconds of every batch
completed over the time from the first call to the last result.

``--trace 1``: the window calls the layers one after another as the
program's forward does (frontend, encoder, decode), timing the frontend
and the encoder by CUDA events and the decode by the host clock after a
synchronise; then one more batch runs under the profiler, its frontend and
encoder with the host's events and the benchmark's ranges, its decode with
the device's activity alone.
"""

import importlib
import math
import time

import numpy as np
import torch

from ..check import pad_like_program
from ..frozen import SR
from ..reference.frontend import num_frames
from ..trace import Profile, Ranges, merge

__all__ = ["Capture", "rtfx", "stage", "window"]


class _NoEvent:
    """A CUDA event's interface on the CPU, where no device time exists."""

    def record(self):
        pass

    def elapsed_time(self, other):
        return None


def rtfx(batches, mix, wall):
    """Audio seconds of ``batches`` completed batches over ``wall`` seconds."""
    return batches * mix["batch"] * mix["chunk_seconds"] / wall


def stage(mix, seed, device="cpu"):
    """[distinct_batches][batch] host waveforms of ``chunk_seconds``: the
    formula of ``frozen.speech_like`` (noise at 0.1 under a 3 Hz envelope),
    drawn in one call on ``device`` from the seed and copied to the host."""
    b, n = mix["batch"], mix["distinct_batches"]
    samples = int(mix["chunk_seconds"] * SR)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    noise = torch.randn(n * b, samples, generator=gen, device=device)
    env = 0.5 * (1 + torch.sin(2 * math.pi * 3.0 * torch.arange(samples, device=device,
                                                                dtype=torch.float64) / SR))
    waves = (noise * 0.1 * env.to(torch.float32)).cpu().numpy()
    return [[waves[k * b + i] for i in range(b)] for k in range(n)]


def _as_audio(batches):
    from reazonspeech_tpu_torch.core.interface import AudioData

    return [[AudioData(w, 16000) for w in batch] for batch in batches]


class Capture:
    """While open, records each call of the program's entry: the raw
    (tokens, frames, counts) its batch decode returns, and the rows
    ``rows(k)`` of the encoder output of call ``k`` (the function the
    family names in ``ENCODER``, as the entry calls it), with their valid
    frames, left on the device."""

    def __init__(self, family, model, rows):
        self.family, self.model, self.rows = family, model, rows
        self.outs, self.encs = [], []

    def __enter__(self):
        module, self._name = self.family.ENCODER
        self._mod = importlib.import_module(module)
        self._enc = getattr(self._mod, self._name)
        self._dec = self.model.decode_batch

        def encode(*args, **kwargs):
            enc, lens = self._enc(*args, **kwargs)
            idx = self.rows(len(self.encs))
            self.encs.append((enc.index_select(0, idx), lens.index_select(0, idx)))
            return enc, lens

        def decode_batch(waveforms, lengths):
            out = self._dec(waveforms, lengths)
            self.outs.append(out[:3])
            return out

        setattr(self._mod, self._name, encode)
        self.model.decode_batch = decode_batch
        return self

    def clear(self):
        self.outs.clear()
        self.encs.clear()

    def __exit__(self, *exc):
        setattr(self._mod, self._name, self._enc)
        self.model.decode_batch = self._dec


def _served(outs):
    """[(tokens, frames)] of each utterance of each batch's outputs."""
    return [[(t[i, :int(c[i])].tolist(), f[i, :int(c[i])].tolist()) for i in range(len(c))]
            for t, f, c in outs]


def _rows(run, n_batches):
    """call index -> the sampled rows of its batch (``run.sample``), as an
    index on the device."""
    per = [torch.tensor(sorted(i for d, i in run.sample if d == b), dtype=torch.long,
                        device=run.device) for b in range(n_batches)]
    return lambda k: per[k % n_batches]


def results(outs, encs, n_batches):
    """Each call's (batch index, [(tokens, frames)] of every row, encoder
    rows [r, T, D] of its sampled rows in order, their valid frames)."""
    return [(k % n_batches, served, enc, lens.tolist())
            for k, (served, (enc, lens)) in enumerate(zip(_served(outs), encs))]


def window(run, model, batches):
    """Warm up and measure; returns :func:`results` of the window's calls."""
    mix, cfg, fam = run.mix, run.cfg, run.family
    n = len(batches)
    order = lambda k: batches[k % n]  # noqa: E731
    if not run.trace:
        audios = _as_audio(batches)
        with Capture(fam, model, _rows(run, n)) as cap:
            fam.transcribe_batch(model, audios[0])  # warm-up: every shape of the window
            cap.clear()
            run.setup_done()
            t0, k = time.perf_counter(), 0
            while True:
                fam.transcribe_batch(model, audios[k % n])
                k += 1
                if time.perf_counter() - t0 >= run.seconds:
                    break
            wall = time.perf_counter() - t0
        run.record(e2e={"rtfx": rtfx(k, mix, wall)}, attempted=k * mix["batch"], failed=0,
                   note=f"window {wall:.4f} s, {k} batches of {mix['batch']} x "
                        f"{mix['chunk_seconds']} s")
        return results(cap.outs, cap.encs, n)

    fe, enc, dec = fam.layers(model)
    cuda = run.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(run.device)) if cuda else (lambda: None)
    rows = _rows(run, n)
    encs = []

    def one(k, spans=None, profiles=None):
        buf, lengths = pad_like_program(order(k), cfg)
        t0 = time.perf_counter()
        with torch.inference_mode():
            wav = torch.from_numpy(buf).to(run.device)
            lens = torch.from_numpy(lengths.astype(np.int32)).to(run.device)
            ev = [torch.cuda.Event(enable_timing=True) if cuda else _NoEvent() for _ in range(3)]
            if profiles is not None:
                with Ranges(run.range_targets) as ranges, Profile(cpu=True) as pa:
                    feats, flens = fe(wav, lens)
                    x, xlens = enc(feats, flens)
                with Profile(cpu=False) as pb:
                    toks, frs, cnts = dec(x, xlens)
                profiles += [pa, pb, ranges]
            else:
                ev[0].record()
                feats, flens = fe(wav, lens)
                ev[1].record()
                x, xlens = enc(feats, flens)
                ev[2].record()
                encs.append((x.index_select(0, rows(k)), xlens.index_select(0, rows(k))))
                sync()
                t_dec = time.perf_counter()
                toks, frs, cnts = dec(x, xlens)
                sync()
                t_end = time.perf_counter()
            out = tuple(v.cpu().numpy() for v in (toks, frs, cnts))
            n_enc = xlens.cpu().numpy()
        wall = time.perf_counter() - t0
        if spans is not None:
            spans["frontend_ms"].append(ev[0].elapsed_time(ev[1]))
            spans["encoder_ms"].append(ev[1].elapsed_time(ev[2]))
            spans["decode_ms"].append((t_end - t_dec) * 1e3)
            spans["batch_s"].append(wall)
            n_feat = num_frames(cfg["frontend"], lengths)
            spans["flops"].append(sum(fam.flops(cfg, int(a), int(b), int(c))
                                      for a, b, c in zip(n_feat, n_enc, out[2])))
            spans["steps"].append(int(n_enc.max() + out[2].max()))
        return out

    one(0)  # warm-up
    encs.clear()
    sync()
    run.setup_done()
    spans = {k: [] for k in ("frontend_ms", "encoder_ms", "decode_ms", "batch_s", "flops",
                             "steps")}
    outs, t0, k = [], time.perf_counter(), 0
    while True:
        outs.append(one(k, spans))
        k += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall, t1 = time.perf_counter() - t0, time.perf_counter()
    profiles = []
    one(k, profiles=profiles)
    pa, pb, ranges = profiles
    busy, win, breakdown = merge([pa, pb], ["frontend+encoder", "decode"])
    run.record(attempted=k * mix["batch"], failed=0, spans=spans, busy_s=busy, window_s=win,
               breakdown=breakdown, ranges=(pa.range_ms, ranges.calls),
               note=f"traced window {wall:.4f} s, {k} batches; frames + labels of each "
                    f"batch's longest alignment {spans['steps']}; profiled batch: "
                    f"{pa.wall_s:.4f} s frontend+encoder, {pb.wall_s:.4f} s decode, "
                    f"{busy:.4f} s device busy; profile and its reading "
                    f"{time.perf_counter() - t1:.2f} s")
    return results(outs, encs, n)
