"""The RNN-T training step (waveform -> loss -> parameter update), PyTorch.

Port of ``reazonspeech_tpu.training.train_step``: the frontend and encoder
code paths of inference, differentiated end to end (the encoder's kernels
through the ops' ``*_diff`` wrappers). Every leaf of the param tree is
trained, the batch-norm statistics included, as the reference's
``jax.value_and_grad`` over the whole tree. The default optimizer is
``torch.optim.AdamW(lr=1e-4, weight_decay=0.01)``, the formula of the
reference's ``optax.adamw(1e-4, weight_decay=0.01)``.
"""

from dataclasses import dataclass
from typing import Any

import torch

from ..frontend.features import FrontendConfig, log_mel_spectrogram
from ..models.fastconformer import FastConformerConfig, fastconformer_encode
from ..models.rnnt import RNNTConfig, joint_full, predictor_sequence
from .losses import rnnt_loss

__all__ = ["TrainState", "make_train_step", "compute_loss", "tree_leaves", "tree_map"]

@dataclass
class TrainState:
    params: Any
    optimizer: Any  # the torch optimizer over the param leaves; its state_dict is the opt state
    step: int


def tree_leaves(tree):
    """The tensors of a nested dict/list, in the order of the keys' sort
    (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict/list (a list keeps its type:
    ``parallel.mesh.Shards`` stays one)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def compute_loss(params, batch, fe_cfg: FrontendConfig, enc_cfg: FastConformerConfig,
                 rnnt_cfg: RNNTConfig, ctc_weight: float = 0.0, loss: str = "full",
                 s_range: int = 5, simple_scale: float = 0.5, pipeline=None, mesh=None):
    """batch: {waveform [B, N] f32, lengths [B] i32, labels [B, U] i32,
    label_lengths [B] i32} (tensors on the params' device) -> the scalar
    mean NLL.

    ``loss="full"`` materialises the [B, T, U+1, V] joint; ``"pruned"``
    trains the simple + pruned objective (``training.pruned_rnnt``; params
    need a "simple_joint" entry). ``ctc_weight > 0`` (params need a "ctc"
    head, blank 0) trains ``(1-w)·rnnt + w·ctc``.

    ``pipeline``: a ``parallel.pipeline.PipelineSpec``: the encoder runs
    under the GPipe schedule over its mesh (autograd through it is the
    backward pipeline). ``mesh``: a ``('data', 'model')`` mesh over which
    ``params`` were placed by ``parallel.mesh.shard_params``: the batch
    splits over ``data`` and the encoder runs as partials over ``model``
    (``parallel.tensor``)."""
    loss_kw = dict(ctc_weight=ctc_weight, loss=loss, s_range=s_range, simple_scale=simple_scale)
    if mesh is not None:
        from ..parallel.tensor import sharded_loss

        return sharded_loss(params, batch, fe_cfg, enc_cfg, rnnt_cfg, mesh, **loss_kw)
    feats, flens = log_mel_spectrogram(batch["waveform"], batch["lengths"], fe_cfg)
    if pipeline is not None:
        from ..parallel.pipeline import pipeline_encode_core

        enc, elens = pipeline_encode_core(params["encoder"], feats, flens, enc_cfg,
                                          pipeline.mesh, pipeline.axis, pipeline.data_axis,
                                          pipeline.n_micro)
    else:
        enc, elens = fastconformer_encode(params["encoder"], feats, flens, enc_cfg)
    return transducer_loss(params, batch, enc, elens, rnnt_cfg, **loss_kw)


def transducer_loss(params, batch, enc, elens, rnnt_cfg: RNNTConfig, ctc_weight=0.0,
                    loss="full", s_range=5, simple_scale=0.5):
    """The objective of :func:`compute_loss` on the encoder's output."""
    pred = predictor_sequence(params["predictor"], batch["labels"], rnnt_cfg)
    if loss == "pruned":
        from .pruned_rnnt import pruned_loss_bundle

        per_utt, _ = pruned_loss_bundle(
            params["simple_joint"], params["joint"], enc, pred, batch["labels"], elens,
            batch["label_lengths"], rnnt_cfg, s_range=s_range, simple_scale=simple_scale)
        nll = per_utt.mean()
    else:
        logits = joint_full(params["joint"], enc, pred, rnnt_cfg)
        nll = rnnt_loss(logits, elens, batch["labels"], batch["label_lengths"],
                        rnnt_cfg.blank_id).mean()
    if ctc_weight > 0.0:
        from ..models.conformer import ctc_logits
        from .losses import ctc_loss

        c_logits = ctc_logits(params["ctc"], enc)
        # the espnet CTC convention: blank == 0
        c_nll = ctc_loss(c_logits, elens, batch["labels"], batch["label_lengths"], 0).mean()
        nll = (1.0 - ctc_weight) * nll + ctc_weight * c_nll
    return nll


def make_train_step(fe_cfg, enc_cfg, rnnt_cfg, optimizer=None, ctc_weight=0.0, loss="full",
                    s_range=5, simple_scale=0.5, pipeline=None, grad_clip=None, schedule=None,
                    mesh=None):
    """Returns (init_state, train_step).

    ``optimizer(leaves)`` makes a torch optimizer over the list of param
    leaves (default AdamW, lr 1e-4, weight decay 0.01). ``init_state(params)``
    makes every leaf a trainable leaf tensor and returns a
    :class:`TrainState`; ``train_step(state, batch)`` updates it in place and
    returns ``(state, {"loss", "grad_norm"})`` (tensors on the device; the
    norm of the gradients before any clip). ``grad_clip`` clips the
    gradients by their global norm first, and ``schedule(step)`` sets the
    learning rate of the update that takes the state from ``step`` (the
    Trainer's chain, as optax counts its updates from 0). ``pipeline`` and
    ``mesh`` are :func:`compute_loss`'s: the leaves may then lie on several
    devices (the optimizer updates each where it is)."""
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=1e-4, weight_decay=0.01)

    def init_state(params):
        params = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
        return TrainState(params=params, optimizer=optimizer(tree_leaves(params)), step=0)

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        batch = _to_device(batch, leaves[0].device)
        loss_val = compute_loss(state.params, batch, fe_cfg, enc_cfg, rnnt_cfg, ctc_weight,
                                loss, s_range, simple_scale, pipeline, mesh)
        grads = torch.autograd.grad(loss_val, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        gnorm = global_norm(grads)
        if grad_clip is not None:
            # optax.clip_by_global_norm as written: g / norm · clip once the
            # norm reaches clip (no epsilon, unlike clip_grad_norm_'s 1e-6)
            keep = gnorm < grad_clip
            grads = [torch.where(keep.to(g.device), g, g / gnorm.to(g.device, g.dtype) * grad_clip)
                     for g in grads]
        for x, g in zip(leaves, grads):
            x.grad = g
        if schedule is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss_val.detach(), "grad_norm": gnorm}

    return init_state, train_step


def global_norm(grads):
    """optax.global_norm: the L2 norm over every leaf, in fp32 (on the
    first leaf's device)."""
    dev = grads[0].device
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))).to(dev) for g in grads))
