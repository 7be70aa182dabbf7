"""Training for the port (``reazonspeech_tpu.training`` in PyTorch): the
RNN-T, pruned and CTC losses, the train step, the Trainer and manifest
batches. The encoder's kernels train through the ops' ``*_diff`` wrappers
(the kernel forward, the plain twin's backward)."""

from .data import manifest_batches, prefetch, read_manifest
from .losses import ctc_loss, rnnt_loss, transducer_nll_from_transitions
from .pruned_rnnt import (
    init_simple_joint, prune_ranges, pruned_loss_bundle, rnnt_loss_pruned, rnnt_loss_simple,
    simple_transitions,
)
from .train_step import TrainState, compute_loss, make_train_step
from .trainer import Trainer, TrainerConfig, warmup_cosine_decay_schedule

__all__ = [
    "Trainer", "TrainerConfig", "TrainState", "compute_loss", "ctc_loss", "init_simple_joint",
    "make_train_step", "manifest_batches", "prefetch", "prune_ranges", "pruned_loss_bundle",
    "read_manifest", "rnnt_loss", "rnnt_loss_pruned", "rnnt_loss_simple", "simple_transitions",
    "transducer_nll_from_transitions", "warmup_cosine_decay_schedule",
]
