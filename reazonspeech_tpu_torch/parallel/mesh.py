"""Device mesh and the tensor-parallel sharding rules (PyTorch).

Port of ``reazonspeech_tpu.parallel.mesh``. One process drives the whole
mesh, as in the JAX package: a :class:`Mesh` is an array of
``torch.device`` entries with axis names, ``("data", "model")`` here, and
the code that runs on it places each tensor on its entry explicitly. An
entry may name the same device as another: on the CPU every entry is
``cpu``, on one card every entry is ``cuda:0``, and on a machine with more
cards the entries spread across them. Autograd carries gradients across the
``.to(device)`` copies between entries, so the sharded backward needs no
hand-written collective.

Sharding rules are path-based over the param tree, as in the JAX package:

- FFN: in-proj column-sharded, out-proj row-sharded (the Megatron layout:
  one reduction per FFN);
- attention q/k/v/pos column-sharded over heads, out-proj row-sharded, the
  position biases split by head;
- conv modules, norms, predictor and joint are replicated.

:func:`shard_params` puts each model-axis shard of a leaf on its own entry:
the leaf becomes a :class:`Shards` list of ``n_model`` tensors, shard ``j``
on model entry ``j`` of the first data row. A leaf whose axis does not divide stays whole.
``parallel/tensor.py`` runs the encoder on such a tree.
"""

import re

import numpy as np
import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "Shards", "cuda_devices", "make_mesh",
           "param_spec", "replicate", "shard_batch", "shard_params", "unshard_params"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An n-d array of ``torch.device`` entries with one name per axis.

    ``shape`` maps each axis name to its size, in axis order
    (``mesh.shape[DATA_AXIS]``, as in JAX); ``devices`` is the numpy array
    of entries."""

    def __init__(self, devices: np.ndarray, axis_names):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d array of devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


class Shards(list):
    """A leaf split over the model axis: one tensor per model entry (a
    list, so tree walks that expand lists reach every shard)."""


def cuda_devices():
    """The visible CUDA devices, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data=None, n_model=1, devices=None) -> Mesh:
    """A ``('data', 'model')`` mesh.

    ``devices``: the entries, row-major (any ``torch.device``, repeats
    allowed); their count must be ``n_data * n_model``. With none, the
    mesh takes the visible CUDA devices: all of them when ``n_data`` is
    None, else the first ``n_data * n_model``. Fewer cards than the mesh
    needs raise a ValueError; the mesh never falls back to the CPU."""
    if devices is None:
        visible = cuda_devices()
        if n_data is None:
            n_data = len(visible) // n_model
        need = n_data * n_model
        if need == 0 or len(visible) < need:
            raise ValueError(
                f"mesh {n_data}x{n_model} needs {need} CUDA devices, {len(visible)} visible; "
                "pass devices= explicitly (entries may repeat a device, e.g. "
                "[torch.device('cuda', 0)] * n)")
        devices = visible[:need]
    devices = list(devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    arr = np.empty((n_data, n_model), dtype=object)
    for i, dev in enumerate(devices):
        arr[divmod(i, n_model)] = torch.device(dev)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


# (regex over the 'a/b/c' path) -> the spec of the *trailing* dims; a leading
# stacked-layer axis is kept unsharded
_RULES = [
    (r"ffn\d_in/w$", (None, MODEL_AXIS)),
    (r"ffn\d_in/b$", (MODEL_AXIS,)),
    (r"ffn\d_out/w$", (MODEL_AXIS, None)),
    (r"attn_(q|k|v|pos)/w$", (None, MODEL_AXIS)),
    (r"attn_(q|k|v)/b$", (MODEL_AXIS,)),
    (r"attn_out/w$", (MODEL_AXIS, None)),
    (r"attn_bias_[uv]$", (MODEL_AXIS, None)),
]


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree of dicts and lists ('a/0/b' paths); a
    :class:`Shards` list is one leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Shards):
        items = enumerate(tree)
    else:
        return fn(path, tree)
    out = {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in items}
    return out if isinstance(tree, dict) else type(tree)(out.values())


def _leaf_spec(path, leaf, stacked_prefixes):
    spec = ()
    for pat, p in _RULES:
        if re.search(pat, path):
            spec = p
            break
    if spec and any(path.startswith(pre) for pre in stacked_prefixes):
        spec = (None, *spec)
    # don't shard leaves with fewer dims than the rule (tiny test configs)
    return () if len(spec) > getattr(leaf, "ndim", 0) else spec


def param_spec(params, stacked_prefixes=("encoder/blocks",)):
    """The spec tree of a param tree: per leaf a tuple naming the mesh axis
    of each leading dim (``None``: not split), ``()`` for a replicated
    leaf; the JAX package's ``PartitionSpec`` tree, leaf for leaf. Leaves
    under ``stacked_prefixes`` have a leading layer axis, unsharded."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, leaf, stacked_prefixes), params)


def model_dim(spec):
    """The dim a spec splits over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_params(params, mesh: Mesh, stacked_prefixes=("encoder/blocks",)):
    """Place a param tree for tensor parallelism: a leaf the rules split
    becomes a list of ``n_model`` shards, shard ``j`` on entry ``(0, j)``;
    every other leaf (and a leaf whose split dim does not divide) stays
    whole on entry ``(0, 0)``. Each model entry then holds 1/n_model of
    the FFN and attention weights. With ``n_model == 1`` nothing is split."""
    n_model = int(mesh.shape[MODEL_AXIS])
    row = mesh.devices[0]

    def put(path, leaf):
        dim = model_dim(_leaf_spec(path, leaf, stacked_prefixes))
        if n_model == 1 or dim is None or leaf.shape[dim] % n_model:
            return leaf.to(row[0])
        return Shards(part.contiguous().to(row[j])
                      for j, part in enumerate(leaf.chunk(n_model, dim)))

    return _map_with_path(put, params)


def unshard_params(params, device=None, stacked_prefixes=("encoder/blocks",)):
    """The whole tree of a :func:`shard_params` tree: each list of shards
    concatenated along its split dim (on ``device``, default the first
    shard's)."""

    def join(path, leaf):
        if not isinstance(leaf, Shards):
            return leaf if device is None else leaf.to(device)
        dev = device or leaf[0].device
        dim = model_dim(_leaf_spec(path, leaf[0], stacked_prefixes))
        return torch.cat([part.to(dev) for part in leaf], dim)

    return _map_with_path(join, params)


def replicate(tree, device):
    """``tree`` (dicts, lists, tensors) with every tensor on ``device``
    (tensors already there are shared, not copied)."""
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def shard_batch(batch, mesh: Mesh):
    """Split a batch dict's leading (batch) dim over the data axis: a list
    of ``n_data`` dicts, shard ``d`` on entry ``(d, 0)``. The batch must
    divide."""
    n_data = int(mesh.shape[DATA_AXIS])
    shards = [{} for _ in range(n_data)]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % n_data:
            raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not divide over the "
                             f"'{DATA_AXIS}' axis ({n_data})")
        for d, part in enumerate(v.chunk(n_data)):
            shards[d][k] = part.to(mesh.devices[d, 0])
    return shards
