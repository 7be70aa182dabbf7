"""Data-parallel serving: one process drives every device of a mesh.

Port of ``reazonspeech_tpu.parallel.serving``. The MicroBatcher's coalesced
waveform batch is split over the mesh ``data`` axis and every entry runs the
whole pipeline (frontend → encoder → decode) on its rows. Decode is
embarrassingly data-parallel: the only traffic is the rows going out and the
token buffers coming back.

Each data entry has a worker thread of its own, which runs the container's
``decode_batch_fn()`` in inference mode on a CUDA stream of its own (so the
kernels' per-stream workspaces are never shared), and the params are copied
once per distinct device: entries that repeat a device share one copy. A
worker's failure fails the call.

``DataParallelDecoder`` keeps the container contract (``decode_batch``,
``decode_single``, ``bucket_samples``, attribute delegation), so it drops
into :class:`serving.MicroBatcher` unchanged::

    mesh = make_mesh(n_data=2)
    batcher = MicroBatcher(DataParallelDecoder(model, mesh), max_batch=32)
"""

import contextlib
import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..device import host_to_device
from .mesh import DATA_AXIS, replicate

__all__ = ["DataParallelDecoder"]


class _EntryWorker:
    """A thread that runs functions on one mesh entry: in inference mode,
    with ``device`` current and, on CUDA, on a stream of its own."""

    def __init__(self, device, name):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._jobs = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    def _context(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _loop(self):
        with self._context():
            while True:
                job = self._jobs.get()
                if job is None:
                    return
                fn, fut = job
                try:
                    fut.set_result(fn())
                except Exception as e:  # handed to the caller through the future
                    fut.set_exception(e)

    def submit(self, fn) -> Future:
        fut = Future()
        self._jobs.put((fn, fut))
        return fut

    def close(self):
        self._jobs.put(None)
        self._thread.join(timeout=60)


class DataParallelDecoder:
    """Split a container's batched decode over the mesh ``data`` axis.

    Args:
      model: a flavor container exposing ``decode_batch_fn()`` (nemo,
        espnet and k2 do): a ``(params, waveforms, lengths) -> outputs``
        closure over its configs, on tensors of one device
      mesh: a :func:`parallel.mesh.make_mesh` mesh; only its ``data`` axis
        is used (entry ``(d, 0)`` decodes shard ``d``; serving models fit
        on one device, so the params are replicated)

    Exposes the MicroBatcher model contract: ``decode_batch``,
    ``decode_single``, ``bucket_samples``, plus ``batch_multiple`` (the
    MicroBatcher rounds its batch buckets up to the data axis).
    """

    def __init__(self, model, mesh):
        self.model = model
        self.mesh = mesh
        self.n_data = int(mesh.shape[DATA_AXIS])
        self.batch_multiple = self.n_data
        self.bucket_samples = getattr(model, "bucket_samples", 4 * 16000)
        self.devices = [mesh.devices[d, 0] for d in range(self.n_data)]
        self._fn = model.decode_batch_fn()
        # params once per distinct device (the model's own where it is one)
        self._params = {dev: replicate(model.params, dev) for dev in dict.fromkeys(self.devices)}
        self._workers = [_EntryWorker(dev, f"DataParallelDecoder-{d}")
                         for d, dev in enumerate(self.devices)]

    def __getattr__(self, name):
        # everything else (tokenizer, rnnt_cfg, fe_cfg, ...) comes from the
        # wrapped container, so flavor-level code (transcribe_batch, the
        # evaluation harness) runs unchanged over the mesh; only called on
        # an attribute miss
        return getattr(self.model, name)

    def _shard(self, dev, wav, lens):
        out = self._fn(self._params[dev], host_to_device(wav, dev), host_to_device(lens, dev))
        return [x.cpu().numpy() for x in out]

    def decode_batch(self, waveforms, lengths):
        """[B, N] float32 + [B] int32 -> host numpy per-element outputs (the
        wrapped container's ``decode_batch_fn`` outputs). A batch that does
        not divide over the data axis is padded with empty rows and
        trimmed."""
        waveforms = np.asarray(waveforms, np.float32)
        lengths = np.asarray(lengths, np.int32)
        b = waveforms.shape[0]
        b_pad = -(-b // self.n_data) * self.n_data
        if b_pad != b:
            waveforms = np.pad(waveforms, ((0, b_pad - b), (0, 0)))
            lengths = np.pad(lengths, (0, b_pad - b))
        rows = b_pad // self.n_data
        futs = [w.submit(lambda d=d, w=w: self._shard(
                    w.device, waveforms[d * rows:(d + 1) * rows], lengths[d * rows:(d + 1) * rows]))
                for d, w in enumerate(self._workers)]
        shards = [f.result() for f in futs]  # a shard's exception fails the call
        outs = tuple(np.concatenate(parts)[:b] for parts in zip(*shards))
        post = getattr(self.model, "_host_decode_flags", None)
        if post is not None:
            post(outs)
        return outs

    def decode_single(self, waveform):
        """One utterance over the mesh (the batch padded to the data axis;
        the other shards decode empty rows)."""
        n = len(waveform)
        padded = max(self.bucket_samples, -(-n // self.bucket_samples) * self.bucket_samples)
        buf = np.zeros((self.n_data, padded), np.float32)
        lens = np.zeros(self.n_data, np.int32)
        buf[0, :n] = waveform
        lens[0] = n
        tokens, frames, counts = self.decode_batch(buf, lens)[:3]
        c = int(counts[0])
        return tokens[0, :c].tolist(), frames[0, :c].tolist()

    def close(self):
        """Stop the entries' worker threads."""
        for w in self._workers:
            w.close()
