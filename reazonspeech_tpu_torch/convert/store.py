"""Native parameter-tree storage, without JAX.

The same format as ``reazonspeech_tpu.convert.store``: a ``.npz`` of the
flattened leaves, keyed by their ``/``-joined tree path, plus a JSON sidecar
holding the tree structure (``spec``) and ``meta`` (configs, tokenizer
pointer). A tree written by either package loads in the other.
"""

import json

import numpy as np

__all__ = ["save_param_tree", "load_param_tree"]

_SEP = "/"


def _leaf_to_numpy(x):
    if hasattr(x, "detach"):  # torch.Tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = _leaf_to_numpy(tree)
    return out


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec(v) for v in tree]
    return None


def _unflatten(spec, flat, prefix=""):
    if isinstance(spec, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}{_SEP}") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_unflatten(v, flat, f"{prefix}{i}{_SEP}") for i, v in enumerate(spec)]
    return flat[prefix.rstrip(_SEP)]


def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar(path):
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def save_param_tree(path, params, meta=None):
    """Write params (numpy or torch leaves) to ``<path>.npz`` + ``<path>.json``."""
    np.savez(_npz(path), **_flatten(params))
    with open(_sidecar(path), "w") as f:
        json.dump({"spec": _spec(params), "meta": meta or {}}, f)


def load_param_tree(path):
    """Read (params, meta) written by save_param_tree; leaves are numpy."""
    with open(_sidecar(path)) as f:
        side = json.load(f)
    with np.load(_npz(path)) as npz:
        flat = dict(npz)
    return _unflatten(side["spec"], flat), side.get("meta", {})
