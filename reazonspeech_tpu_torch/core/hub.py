"""Offline-first Hugging Face Hub checkpoint resolution.

A copy of ``reazonspeech_tpu/core/hub.py`` with the same behaviour and the
same converted-tree cache layout, so both packages read the same trees,
except that resolution never reaches the network: a snapshot must already
be in the local cache.

The reference resolves published model weights through the HF Hub with a
local-cache-first policy (pkg/k2-asr/src/huggingface.py:68-71: try
``snapshot_download(local_files_only=True)``, fall back to the network;
pkg/nemo-asr/src/transcribe.py:27-28 and pkg/espnet-asr/src/transcribe.py:28-31
use ``from_pretrained`` which does the same under the hood).

This module reads the hub cache layout
(``<cache>/models--{org}--{name}/snapshots/{rev}/``) directly, preferring the
revision recorded in ``refs/main``, without requiring ``huggingface_hub`` to
be importable. When it IS available, its ``local_files_only`` lookup is
tried as well.

Converted parameter trees (our ``.npz`` format, convert/store.py) are cached
under ``$REAZONSPEECH_TPU_CACHE`` (default ``~/.cache/reazonspeech_tpu``) so
the torch->JAX conversion runs once per published checkpoint.
"""

import glob
import os

__all__ = [
    "CheckpointNotFoundError",
    "hub_cache_dirs",
    "find_cached_snapshot",
    "resolve_snapshot",
    "converted_cache_dir",
    "converted_path",
]


class CheckpointNotFoundError(FileNotFoundError):
    """No resolvable checkpoint. The message carries remediation steps."""


def hub_cache_dirs():
    """Candidate HF hub cache directories, highest priority first.

    Mirrors huggingface_hub's resolution: $HF_HUB_CACHE > $HF_HOME/hub >
    ~/.cache/huggingface/hub.
    """
    dirs = []
    if os.environ.get("HF_HUB_CACHE"):
        dirs.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        dirs.append(os.path.join(os.environ["HF_HOME"], "hub"))
    dirs.append(os.path.expanduser("~/.cache/huggingface/hub"))
    return dirs


def _repo_dirname(repo_id):
    return "models--" + repo_id.replace("/", "--")


def find_cached_snapshot(repo_id, require=()):
    """Locate a locally cached snapshot of ``repo_id`` (no network).

    Args:
      repo_id: e.g. "reazon-research/reazonspeech-nemo-v2"
      require: glob patterns that must match inside the snapshot for it to
        count (guards against partially downloaded snapshots)

    Returns: snapshot directory path, or None.
    """
    for cache in hub_cache_dirs():
        repo = os.path.join(cache, _repo_dirname(repo_id))
        snaps = os.path.join(repo, "snapshots")
        if not os.path.isdir(snaps):
            continue
        candidates = []
        # prefer the revision refs/main points at (what hub clients update)
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                rev = f.read().strip()
            main = os.path.join(snaps, rev)
            if os.path.isdir(main):
                candidates.append(main)
        others = sorted(
            (os.path.join(snaps, d) for d in os.listdir(snaps)),
            key=os.path.getmtime,
            reverse=True,
        )
        candidates += [d for d in others if d not in candidates and os.path.isdir(d)]
        for snap in candidates:
            if all(
                glob.glob(os.path.join(snap, "**", pat), recursive=True)
                for pat in require
            ):
                return snap
    return None


def resolve_snapshot(repo_id, require=()):
    """Local-cache snapshot resolution (no network).

    Tries the local cache layout, then
    ``huggingface_hub.snapshot_download(local_files_only=True)`` when
    importable. Raises CheckpointNotFoundError with remediation
    instructions otherwise.
    """
    snap = find_cached_snapshot(repo_id, require=require)
    if snap:
        return snap
    try:
        import huggingface_hub as hf

        return hf.snapshot_download(repo_id, local_files_only=True)
    except Exception:  # not importable, or nothing cached
        pass
    raise CheckpointNotFoundError(_missing_msg(repo_id))


def _missing_msg(repo_id):
    lines = [
        f"No checkpoint found for '{repo_id}'.",
        "To use published weights, place a snapshot of the repo in the HF",
        "cache (~/.cache/huggingface/hub, or set $HF_HUB_CACHE/$HF_HOME), e.g.",
        f"  huggingface-cli download {repo_id}",
        "or pass checkpoint=<path-to-converted-.npz> explicitly.",
        "For a randomly initialized model (tests/benchmarks only), pass",
        "checkpoint=\"random\".",
    ]
    return "\n".join(lines)


def converted_cache_dir():
    """Directory for converted .npz param trees (one conversion per repo)."""
    return os.environ.get(
        "REAZONSPEECH_TPU_CACHE", os.path.expanduser("~/.cache/reazonspeech_tpu")
    )


def converted_path(repo_id, tag="model"):
    """Base path (no extension) of the converted tree for ``repo_id``."""
    return os.path.join(converted_cache_dir(), _repo_dirname(repo_id), tag)


def resolve_converted(repo_id, tag, converter, require=()):
    """Resolution chain for a flavor's converted checkpoint.

    Order (mirrors the reference's offline-first policy; the flavor-specific
    env vars are resolved by the callers before reaching here):
      1. the converted-tree cache (one conversion per published repo);
      2. a locally cached HF snapshot, run through
         ``converter(snapshot_dir, out_base)`` and cached.

    Returns the ``.npz`` base path. Raises CheckpointNotFoundError when
    nothing resolves — loaders must NOT silently fall back to random
    weights (that is opt-in via checkpoint="random").
    """
    out = converted_path(repo_id, tag)
    if os.path.exists(out + ".npz"):
        return out
    snap = resolve_snapshot(repo_id, require=require)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    converter(snap, out)
    return out
