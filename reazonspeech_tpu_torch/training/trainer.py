"""Training driver: the schedule, checkpoint and resume, logging (PyTorch).

Port of ``reazonspeech_tpu.training.trainer`` around ``train_step.py``:
step-numbered checkpoints of the whole training state (params, optimizer
state, step), resume from the newest, warmup-cosine AdamW after a clip by
global norm, JSONL metric logging. Orbax is a JAX library, so a
checkpoint is the port's own file: ``step_{:08d}/state.pt``, one
``torch.save`` of {params, optimizer, step}. ``mesh=`` trains data x tensor
parallel (``parallel.mesh.shard_params``, ``parallel.tensor``) and
``pipeline=`` with the encoder under the GPipe schedule
(``parallel.pipeline``), the params placed on the mesh's entries.
"""

import json
import math
import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, set_fp32_matmul_policy
from .train_step import TrainState, make_train_step, tree_leaves, tree_map

__all__ = ["TrainerConfig", "Trainer", "warmup_cosine_decay_schedule"]

_STATE_FILE = "state.pt"


@dataclass(frozen=True)
class TrainerConfig:
    checkpoint_dir: Optional[str] = None
    save_every: int = 1000
    log_every: int = 50
    keep_checkpoints: int = 3
    # warmup-cosine schedule (NeMo/icefall recipes' shape)
    peak_lr: float = 1e-3
    warmup_steps: int = 1000
    decay_steps: int = 100_000
    end_lr_scale: float = 0.05
    weight_decay: float = 0.01
    grad_clip: float = 5.0
    ctc_weight: float = 0.0
    # "full" = materialized-joint rnnt_loss; "pruned" = icefall-style
    # simple+pruned objective (params need a "simple_joint" entry)
    loss: str = "full"
    s_range: int = 5
    simple_scale: float = 0.5


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0, exponent=1.0):
    """``optax.warmup_cosine_decay_schedule``, value for value: a linear
    warmup from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine decay to ``end_value`` at ``decay_steps`` (warmup included),
    evaluated in float32 in optax's order of operations."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={span}.")

    def warmup(count):
        if warmup_steps <= 0:  # optax: a constant schedule at init_value
            return f32(init_value)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def decay(count):
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * f32(min(count, span)) / f32(span)))
        return f32(peak_value) * (f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha))

    def schedule(count):
        return float(warmup(count) if count < warmup_steps else decay(count - warmup_steps))

    return schedule


def _plain(tree):
    """A param tree of dicts, plain lists and detached tensors."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree.detach()


def _schedule(cfg: TrainerConfig):
    return warmup_cosine_decay_schedule(0.0, cfg.peak_lr, cfg.warmup_steps, cfg.decay_steps,
                                        cfg.peak_lr * cfg.end_lr_scale)


class Trainer:
    """Stateful wrapper around the train step.

    >>> tr = Trainer(fe_cfg, enc_cfg, rnnt_cfg, TrainerConfig(ckpt_dir))
    >>> tr.init(params)            # or tr.restore_latest(params_template)
    >>> tr.fit(batch_iter, max_steps=10_000)

    ``device=None`` means CUDA (raising without a GPU); pass
    ``device="cpu"`` to train on the CPU. The params are moved there.

    ``mesh``: a ``('data', 'model')`` mesh (``parallel.mesh.make_mesh``):
    the params are split by ``parallel.mesh.shard_params``, each batch over
    ``data``, the encoder's FFNs and attention over ``model``.
    ``pipeline``: a ``parallel.pipeline.PipelineSpec``: the params are
    placed by ``shard_params_pipeline`` and the encoder runs under the
    GPipe schedule. Either one sets the devices (``device`` must then be
    None or the mesh's first entry)."""

    def __init__(self, fe_cfg, enc_cfg, rnnt_cfg, cfg: TrainerConfig = TrainerConfig(),
                 mesh=None, pipeline=None, device=None):
        if mesh is not None and pipeline is not None:
            raise ValueError("Trainer: pass mesh= or pipeline=, not both (the pipeline's "
                             "spec carries its own mesh)")
        self.mesh, self.pipeline = mesh, pipeline
        layout = mesh if mesh is not None else getattr(pipeline, "mesh", None)
        if layout is not None:
            first = layout.devices.flat[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"Trainer(device={device!r}): the mesh's first entry is {first}")
            device = first
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device=None) trains on CUDA and no CUDA device is "
                               "available; pass device=\"cpu\" to train on the CPU")
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_matmul_policy()
        self.schedule = _schedule(cfg)

        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=0.0, weight_decay=cfg.weight_decay)

        self._init_state, self._step_fn = make_train_step(
            fe_cfg, enc_cfg, rnnt_cfg, optimizer=optimizer, ctc_weight=cfg.ctc_weight,
            loss=cfg.loss, s_range=cfg.s_range, simple_scale=cfg.simple_scale,
            grad_clip=cfg.grad_clip, schedule=self.schedule, pipeline=pipeline, mesh=mesh)
        self.state: Optional[TrainState] = None
        self.history: list = []

    # -- state ------------------------------------------------------------

    def init(self, params):
        params = tree_map(lambda x: torch.as_tensor(x).to(self.device), params)
        if self.mesh is not None:
            from ..parallel.mesh import shard_params

            params = shard_params(params, self.mesh)
        elif self.pipeline is not None:
            from ..parallel.pipeline import shard_params_pipeline

            params = shard_params_pipeline(params, self.pipeline.mesh, self.pipeline.axis)
        self.state = self._init_state(params)
        return self

    def _ckpt_path(self, step):
        return os.path.join(self.cfg.checkpoint_dir, f"step_{step:08d}")

    def save(self):
        """Write the whole training state (params, optimizer state, step)."""
        if self.cfg.checkpoint_dir is None:
            raise ValueError("TrainerConfig.checkpoint_dir is not set")
        step = int(self.state.step)
        path = os.path.abspath(self._ckpt_path(step))
        os.makedirs(path, exist_ok=True)
        # plain lists (a parallel.mesh.Shards leaf too): restore_latest copies
        # the leaves in order into the template's layout
        tree = {"params": _plain(self.state.params),
                "optimizer": self.state.optimizer.state_dict(), "step": step}
        tmp = os.path.join(path, _STATE_FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
        # retention: keep the newest N
        for s in self.list_checkpoints(self.cfg.checkpoint_dir)[: -self.cfg.keep_checkpoints]:
            shutil.rmtree(self._ckpt_path(s), ignore_errors=True)
        return path

    @staticmethod
    def list_checkpoints(checkpoint_dir):
        """Sorted step numbers of checkpoints under ``checkpoint_dir``."""
        if not os.path.isdir(checkpoint_dir):
            return []
        out = []
        for name in os.listdir(checkpoint_dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, params_template):
        """Resume from the newest checkpoint; ``params_template`` is a tree
        of like-shaped tensors (e.g. a fresh init) fixing the structure.
        Returns self; raises FileNotFoundError if there is none."""
        steps = self.list_checkpoints(self.cfg.checkpoint_dir or "")
        if not steps:
            raise FileNotFoundError(
                f"no step_* checkpoints under {self.cfg.checkpoint_dir}; "
                "call init(params) for a fresh run")
        self.init(params_template)  # the optimizer over the template's leaves
        path = os.path.join(os.path.abspath(self._ckpt_path(steps[-1])), _STATE_FILE)
        tree = torch.load(path, map_location=self.device, weights_only=True)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.state.params), tree_leaves(tree["params"])):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(f"{path}: a leaf {tuple(src.shape)} {src.dtype} where the "
                                     f"template has {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src)
        self.state.optimizer.load_state_dict(tree["optimizer"])
        self.state.step = int(tree["step"])
        return self

    # -- loop -------------------------------------------------------------

    def fit(self, batches, max_steps, log_file=None):
        """Run up to ``max_steps`` optimizer steps over ``batches`` (an
        iterable of dicts: waveform/lengths/labels/label_lengths). Returns
        the metric history ([{step, loss, grad_norm, seconds}])."""
        if self.state is None:
            raise RuntimeError("call init(params) or restore_latest() first")
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        logf = open(log_file, "a") if log_file else None
        t0 = time.perf_counter()
        try:
            for batch in batches:
                if int(self.state.step) >= max_steps:
                    break
                self.state, metrics = self._step_fn(self.state, batch)
                step = int(self.state.step)
                if step % self.cfg.log_every == 0 or step == 1:
                    rec = {
                        "step": step,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "seconds": round(time.perf_counter() - t0, 3),
                    }
                    self.history.append(rec)
                    if logf:
                        logf.write(json.dumps(rec) + "\n")
                        logf.flush()
                if self.cfg.checkpoint_dir and step % self.cfg.save_every == 0:
                    self.save()
        finally:
            if logf:
                logf.close()
        return self.history
