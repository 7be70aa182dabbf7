"""Micro-batching executor for the AVSR (AV-HuBERT seq2seq) flavor.

The port of ``reazonspeech_tpu/serving/avsr.py``. The reference decodes
AVSR one utterance at a time through HF ``generate``
(pkg/avsr/src/avhubert/modeling_avhubert.py:330-391). This executor turns
request concurrency into the batch dimension of ONE beam-generate call per
tick — the ASR :class:`~.batcher.MicroBatcher`'s policy, adapted to the
two-modality input:

- requests carry fused audio features [T, F] and/or mouth-ROI video
  [T, 88, 88]; a missing modality is zero-filled per row, as the JAX
  package's batcher fills it (zero inputs, which the trunk and projections
  map to nonzero features: not ``encode``'s absent modality, whose projected
  features are zeros), so a request's answer equals a dedicated generate of
  the same zero-filled inputs;
- the time axis pads to ``bucket_frames`` multiples and the batch dimension
  to powers of two, so the set of batch shapes stays bounded under organic
  load.

Device interaction, as in :class:`~.continuous.ContinuousBatcher`: the
executor thread does its device work in inference mode on a CUDA stream of
its own, and each host batch goes to the card through a fresh pinned buffer
that is never written after its asynchronous copy is issued.
"""

import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..device import host_to_device

__all__ = ["AVSRBatcher"]


class AVSRBatcher:
    """Coalesce AVSR generate requests into batched beam decodes.

    Args:
      model: :class:`~reazonspeech_tpu_torch.avsr.AVHubertForConditionalGeneration`
      max_batch: hard batch-size cap per tick
      max_wait_ms: how long the first request in a tick waits for company
      bucket_frames: time axis pads to multiples of this (25 fps fused
        frames; 50 = 2 s)
      num_beams / max_length: fixed generate config (vary per batcher
        instance, not per request)
    """

    def __init__(self, model, max_batch=16, max_wait_ms=30.0,
                 bucket_frames=50, num_beams=5, max_length=128):
        self.model = model
        self.cfg = model.config
        self.device = torch.device(model.device)
        self.max_batch = int(max_batch)
        self.max_wait_ms = max_wait_ms
        self.bucket_frames = int(bucket_frames)
        self.num_beams = int(num_beams)
        self.max_length = int(max_length)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._queue = queue.Queue()
        self._running = True
        # bounded for the server's life: a tick counter and the set of the
        # dispatched (b_pad, t_pad) shapes (the bucket grid's)
        self.ticks = 0
        self.batch_shapes = set()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="AVSRBatcher")
        self._thread.start()

    def submit(self, audio=None, video=None) -> Future:
        """Enqueue one utterance; resolves to eos-trimmed token ids.

        audio: [T, audio_feat_dim] fused log-fbank features (or None)
        video: [T, 88, 88] mouth-ROI frames (or None)
        """
        fut = Future()
        if audio is None and video is None:
            fut.set_exception(ValueError("need audio and/or video"))
            return fut
        a = None if audio is None else np.asarray(audio, np.float32)
        v = None if video is None else np.asarray(video, np.float32)
        if a is not None and v is not None and len(a) != len(v):
            fut.set_exception(ValueError(
                f"audio ({len(a)}) and video ({len(v)}) frame counts differ"))
            return fut
        self._queue.put((a, v, fut))
        return fut

    def generate(self, audio=None, video=None):
        return self.submit(audio, video).result()

    def warmup(self, seconds=4.0):
        """Run every batch bucket once at this utterance length (25 fps
        frames; the same contract as MicroBatcher.warmup), so the first
        requests find the library handles made and the allocator's pools
        grown. Padding rows keep length 1, as in serving. Returns the list
        of (b_pad, t_pad) shapes warmed."""
        frames = int(seconds * 25)
        t_pad = max(self.bucket_frames, -(-frames // self.bucket_frames) * self.bucket_frames)
        sizes = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b <<= 1
        sizes.append(self.max_batch)
        warmed = []
        for b_pad in sizes:
            audio = np.zeros((b_pad, t_pad, self.cfg.audio_feat_dim), np.float32)
            video = np.zeros((b_pad, t_pad, 88, 88), np.float32)
            self._generate(audio, video, np.ones((b_pad,), np.int64))
            warmed.append((b_pad, t_pad))
        self.warmed = warmed
        return warmed

    def close(self):
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=30)

    # -- internals -----------------------------------------------------------

    @contextlib.contextmanager
    def _device_work(self):
        """Inference mode, on the executor's own CUDA stream where there is
        one (both are per thread)."""
        stream = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with torch.inference_mode(), stream:
            yield

    def _generate(self, audio, video, lens):
        """One batched generate of padded host arrays -> tokens [B, L] (numpy)."""
        with self._device_work():
            toks = self.model.generate(
                audio=host_to_device(audio, self.device), video=host_to_device(video, self.device),
                lengths=host_to_device(lens, self.device), num_beams=self.num_beams,
                max_length=self.max_length)
            return toks.cpu().numpy()

    def _collect(self):
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = self.max_wait_ms / 1e3
        t0 = time.monotonic()
        while len(items) < self.max_batch:
            remaining = deadline - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)
                break
            items.append(nxt)
        return items

    def _loop(self):
        eos = self.cfg.eos_token_id
        f_dim = self.cfg.audio_feat_dim
        while self._running:
            items = self._collect()
            if items is None:
                return
            try:
                t_max = max(len(a) if a is not None else len(v) for a, v, _ in items)
                t_pad = max(self.bucket_frames,
                            -(-t_max // self.bucket_frames) * self.bucket_frames)
                b = len(items)
                b_pad = min(1 << (b - 1).bit_length(), self.max_batch)
                audio = np.zeros((b_pad, t_pad, f_dim), np.float32)
                video = np.zeros((b_pad, t_pad, 88, 88), np.float32)
                # padding rows keep length 1 (a zero-length encoder mask has
                # no valid key to attend to)
                lens = np.ones((b_pad,), np.int64)
                for i, (a, v, _) in enumerate(items):
                    n = len(a) if a is not None else len(v)
                    lens[i] = n
                    if a is not None:
                        audio[i, :n] = a
                    if v is not None:
                        video[i, :n] = v
                self.ticks += 1
                self.batch_shapes.add((b_pad, t_pad))
                toks = self._generate(audio, video, lens)
                for i, (_, _, fut) in enumerate(items):
                    row = toks[i]
                    hits = np.nonzero(row == eos)[0]
                    end = int(hits[0]) if hits.size else len(row)
                    fut.set_result(row[:end].tolist())
            except Exception as e:  # pragma: no cover - fan the error out
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
