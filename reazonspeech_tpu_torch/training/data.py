"""Manifest-driven training batches (WAV paths + transcriptions -> padded
host batches).

A copy of ``reazonspeech_tpu.training.data`` (that module imports no JAX;
the port keeps its own copy, as it does ``core/``). Input is the JSONL
manifest layout the corpus builder writes: one object per line with
``audio`` (a WAV path) and ``transcription``. Batches are static-shape
(bucketed padding), so the set of shapes a training run sees stays
bounded. The WAVs load through the port's ``native`` thread-pool loader
where the library is available, one by one in Python otherwise.
"""

import json

import numpy as np

__all__ = ["read_manifest", "manifest_batches", "prefetch"]


def read_manifest(path):
    """[{audio, transcription}, ...] from a JSONL manifest."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _bucket(n, step):
    return max(step, -(-n // step) * step)


def _load_wavs(paths):
    """Decode a list of WAV paths to float32 mono arrays: through the C++
    thread-pool loader (``native.wav_batch_load``) when the library is
    available and every file has a PCM WAV header, per-file Python
    otherwise; a file the native decoder refuses falls back on its own."""
    from .. import native
    from ..core.audio import audio_from_path

    def py_one(path):
        return np.asarray(audio_from_path(path).waveform, np.float32)

    if not paths or not native.available():
        return [py_one(p) for p in paths]
    try:
        stride = max(native.wav_info(p)[1] for p in paths)
    except OSError:  # a file that is not a PCM WAV (FLAC, ...)
        return [py_one(p) for p in paths]
    batch, lengths = native.wav_batch_load(paths, max(stride, 1))
    return [batch[i, : lengths[i]] if lengths[i] >= 0 else py_one(p)
            for i, p in enumerate(paths)]


def manifest_batches(
    manifest,
    tokenizer,
    batch_size,
    samples_bucket=16000,
    label_bucket=16,
    epochs=1,
    shuffle=True,
    seed=0,
    drop_unknown=True,
):
    """Yield train-step batches from a manifest (path or row list).

    Waveforms are padded to a multiple of ``samples_bucket`` samples and
    labels to a multiple of ``label_bucket`` tokens, batch-wide, so the set
    of compiled programs stays bounded. Rows whose transcription cannot be
    tokenized are skipped (drop_unknown) or raise.
    """
    rows = read_manifest(manifest) if isinstance(manifest, str) else list(manifest)
    rng = np.random.default_rng(seed)

    if not rows:
        raise ValueError("empty manifest")
    yielded = 0
    for _ in range(epochs):
        order = rng.permutation(len(rows)) if shuffle else np.arange(len(rows))
        for i in range(0, len(order), batch_size):
            idxs = list(order[i : i + batch_size])
            # tail batch: cycle earlier rows to keep the batch static-shape
            # (same policy as the dropped-row refill below) instead of
            # silently discarding len(rows) % batch_size rows per epoch
            k = 0
            while len(idxs) < batch_size:
                idxs.append(order[k % len(order)])
                k += 1
            chunk = [rows[j] for j in idxs]
            kept, labels = [], []
            for r in chunk:
                try:
                    ids = tokenizer.text_to_ids(r["transcription"])
                except (KeyError, ValueError):
                    if drop_unknown:
                        ids = None
                    else:
                        raise
                if ids is None or not ids:
                    continue
                kept.append(r["audio"])
                labels.append(np.asarray(ids, np.int32))
            wavs = _load_wavs(kept)
            if not wavs:
                continue
            yielded += 1
            # keep the batch STATIC-SHAPE even when rows were dropped:
            # cycle valid rows to refill (sharding + compile-count both
            # depend on a stable leading dimension)
            k = 0
            while len(wavs) < batch_size:
                wavs.append(wavs[k % len(labels)])
                labels.append(labels[k % len(labels)])
                k += 1
            n = _bucket(max(len(w) for w in wavs), samples_bucket)
            u = _bucket(max(len(l) for l in labels), label_bucket)
            b = len(wavs)
            waveform = np.zeros((b, n), np.float32)
            lengths = np.zeros((b,), np.int32)
            lab = np.zeros((b, u), np.int32)
            lab_len = np.zeros((b,), np.int32)
            for k, (w, l) in enumerate(zip(wavs, labels)):
                waveform[k, : len(w)] = w
                lengths[k] = len(w)
                lab[k, : len(l)] = l
                lab_len[k] = len(l)
            yield {
                "waveform": waveform,
                "lengths": lengths,
                "labels": lab,
                "label_lengths": lab_len,
            }

    if yielded == 0:
        raise ValueError(
            "no batch could be built: every transcription failed to "
            "tokenize with the given tokenizer (vocabulary mismatch?)"
        )


def prefetch(batches, depth=2):
    """Wrap a batch iterator with a background-thread producer so host-side
    decode/padding overlaps device compute (the data-loader pipelining the
    reference outsources to its toolkits' workers)."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()

    def producer():
        try:
            for b in batches:
                q.put(b)
            q.put(_END)
        except BaseException as e:  # surface errors on the consumer side
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
