"""Pipeline parallelism: the conformer block stack under a GPipe schedule.

Port of ``reazonspeech_tpu.parallel.pipeline``. The layer stack is split
over a ``pipe`` mesh axis, for deployments where one device cannot hold the
whole encoder's weights: each stage holds ``num_layers/S`` blocks on its
entry and activations flow stage to stage with ``.to(device)``. The batch is
split into M microbatches and the schedule runs ``M + S - 1`` ticks: at tick
``t`` stage ``s`` runs microbatch ``t - s`` through its blocks (the port's
own ``_block``, so the kernel impls run unchanged on every stage), and a
stage with no microbatch at a tick (the fill and drain bubble, a share
``(S-1)/(M+S-1)`` of the ticks) computes nothing. One thread issues the
schedule; on distinct cards the stages overlap because launches are
asynchronous.

Composes with data parallelism on a 2-D ``('data', 'pipe')`` mesh: each
microbatch's rows split over ``data``, stage ``s`` of data shard ``d`` on
entry ``(d, s)``.

Training: autograd through the schedule is the backward pipeline (the
``.to()`` copies carry the cotangents back stage by stage, and the
gradients of a stage's weights sum over the microbatches and the data
shards that used them); ``cfg.remat`` recomputes each block in the
backward, the GPipe memory profile.

Scope: the FastConformer block stack (nemo and espnet). The k2 Zipformer's
stacks run at different time resolutions and are not stageable this way.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.fastconformer import (
    FastConformerConfig, _check_supported, _encode_prologue, _run_blocks, layer_norm,
)
from .mesh import DATA_AXIS, Mesh, make_mesh, replicate

__all__ = ["PIPE_AXIS", "PipelineSpec", "make_pipeline_mesh", "pipeline_encode_core",
           "pipeline_parallel_encode", "shard_params_pipeline"]

PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class PipelineSpec:
    """How to pipeline the encoder block stack. Hand to
    ``training.make_train_step(pipeline=...)`` (or ``Trainer(pipeline=...)``)
    to train with the encoder forward and backward under the schedule."""

    mesh: Mesh
    axis: str = PIPE_AXIS
    data_axis: Optional[str] = None
    n_micro: Optional[int] = None


def make_pipeline_mesh(n_pipe, n_data=1, devices=None) -> Mesh:
    """A ``('data', 'pipe')`` mesh: batch over ``data``, layer stack over
    ``pipe``; the entries as :func:`parallel.mesh.make_mesh` takes them."""
    return Mesh(make_mesh(n_data, n_pipe, devices).devices, (DATA_AXIS, PIPE_AXIS))


def _entry(mesh, axis, s, data_axis=None, d=0):
    """The device of stage ``s`` (of data shard ``d``): index ``s`` along
    ``axis``, ``d`` along ``data_axis``, 0 along any other axis."""
    idx = [0] * len(mesh.axis_names)
    idx[mesh.axis_names.index(axis)] = s
    if data_axis is not None:
        idx[mesh.axis_names.index(data_axis)] = d
    return mesh.devices[tuple(idx)]


def _stage_slice(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def shard_params_pipeline(params, mesh: Mesh, axis: str = PIPE_AXIS):
    """Place an encoder param tree for the pipeline: ``blocks`` becomes a
    list of S stage trees (the stacked leaves' layers ``[s·L/S,
    (s+1)·L/S)``), stage ``s`` on its entry; everything else (subsampling,
    after_norm, and the predictor and joint of a full model tree) on the
    first entry. This is what cuts each device's weights to L/S blocks.
    A stack whose depth does not divide stays whole on the first entry.
    Works on a full model tree (with an ``encoder`` entry) or a bare
    encoder tree."""
    n_stage = int(mesh.shape[axis])
    first = _entry(mesh, axis, 0)
    enc = params["encoder"] if "encoder" in params else params
    depth = {v.shape[0] for v in _leaves(enc["blocks"])}
    if len(depth) == 1 and next(iter(depth)) % n_stage == 0:
        k = next(iter(depth)) // n_stage
        blocks = [replicate(_stage_slice(enc["blocks"], s * k, (s + 1) * k),
                            _entry(mesh, axis, s)) for s in range(n_stage)]
    else:
        blocks = replicate(enc["blocks"], first)
    enc = {**{n: replicate(v, first) for n, v in enc.items() if n != "blocks"}, "blocks": blocks}
    if "encoder" in params:
        return {**{n: replicate(v, first) for n, v in params.items() if n != "encoder"},
                "encoder": enc}
    return enc


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _resolve_schedule(b, cfg, mesh, axis, data_axis, n_micro):
    """Validate the (layers, batch, mesh) split and default the microbatch
    count; returns the resolved ``n_micro``."""
    if cfg.seq_axis:
        raise ValueError("the pipeline schedule owns the mesh layout; "
                         "unset cfg.seq_axis (sp+pp is not a supported "
                         "combination — they shard different bottlenecks)")
    n_stage = int(mesh.shape[axis])
    if cfg.num_layers % n_stage:
        raise ValueError(
            f"num_layers ({cfg.num_layers}) must divide by the '{axis}' "
            f"axis size ({n_stage}) — equal-depth stages only")
    n_data = int(mesh.shape[data_axis]) if data_axis is not None else 1
    if n_micro is None:
        for cand in (2 * n_stage, n_stage, 1):
            if b % cand == 0 and (b // cand) % n_data == 0:
                n_micro = cand
                break
        else:
            raise ValueError(
                f"no default microbatch count fits batch ({b}) over "
                f"{n_stage} stages x {n_data} data shards; pass n_micro")
    if b % n_micro:
        raise ValueError(f"batch ({b}) must divide into n_micro ({n_micro}) "
                         "microbatches")
    if (b // n_micro) % n_data:
        raise ValueError(
            f"microbatch size ({b // n_micro}) must divide by the "
            f"'{data_axis}' axis size ({n_data})")
    return n_micro


def pipeline_parallel_encode(params, feats, feat_lengths, cfg: FastConformerConfig, mesh: Mesh,
                             axis: str = PIPE_AXIS, data_axis: str = None, n_micro: int = None):
    """Encode [B, T, F] log-mel features with the block stack split over
    ``mesh[axis]`` under the GPipe schedule; also the training forward
    (autograd through it is the backward pipeline, module notes).

    Same math as ``fastconformer_encode`` on one device: each microbatch runs
    the same blocks, on a different entry per layer group. ``params`` is an
    encoder tree, its ``blocks`` stacked or split by
    :func:`shard_params_pipeline`. Returns ``(encoded [B, T', D] fp32,
    encoded_lengths [B])`` on the first entry.

    Args:
      axis: the mesh axis the layer stack splits over; ``cfg.num_layers``
        must divide by its size.
      data_axis: optional second mesh axis to also split each microbatch's
        rows over (dp x pp on one mesh).
      n_micro: the microbatch count M (default: the larger of ``2*S``/``S``
        that divides B). More microbatches shrink the bubble
        ``(S-1)/(M+S-1)`` at the cost of smaller per-tick products.
    """
    n_micro = _resolve_schedule(feats.shape[0], cfg, mesh, axis, data_axis, n_micro)
    _check_supported(cfg)
    n_stage = int(mesh.shape[axis])
    n_data = int(mesh.shape[data_axis]) if data_axis is not None else 1
    k = cfg.num_layers // n_stage
    first = _entry(mesh, axis, 0)
    x, lengths, pos_emb, mask = _encode_prologue(
        params, feats.to(first), feat_lengths.to(first, torch.int32), cfg)
    key_lengths = mask.sum(dim=-1, dtype=torch.int32)
    blocks = params["blocks"]
    if not isinstance(blocks, list):  # stacked: each stage's layers out of the stack
        blocks = [_stage_slice(blocks, s * k, (s + 1) * k) for s in range(n_stage)]
    # each (data shard, stage) entry's blocks, moved once a call (a no-op
    # where the entry is the stage's own device)
    stage = [[replicate(blocks[s], _entry(mesh, axis, s, data_axis, d)) for s in range(n_stage)]
             for d in range(n_data)]
    bm = x.shape[0] // n_micro
    bd = bm // n_data
    acts, outs = {}, {}
    for tick in range(n_micro + n_stage - 1):
        for s in range(n_stage):
            m = tick - s
            if not 0 <= m < n_micro:  # a bubble tick: this stage waits
                continue
            for d in range(n_data):
                dev = _entry(mesh, axis, s, data_axis, d)
                rows = slice(m * bm + d * bd, m * bm + (d + 1) * bd)
                h = x[rows] if s == 0 else acts[m, d]
                # a fresh lengths tensor: the kernels take 16-byte aligned ones
                h = _run_blocks(stage[d][s], k, h.to(dev), pos_emb.to(dev), mask[rows].to(dev),
                                key_lengths[rows].to(dev, copy=True), cfg)
                (outs if s == n_stage - 1 else acts)[m, d] = h
    enc = torch.cat([outs[m, d].to(first) for m in range(n_micro) for d in range(n_data)])
    if cfg.final_norm:
        enc = layer_norm(params["after_norm"], enc)
    return enc.to(torch.float32), lengths


# the JAX package's name for the training forward: there the public entry
# jits this function; here they are one function
pipeline_encode_core = pipeline_parallel_encode
