"""Kernel-backed ops. Each public op launches a hand-written CUDA kernel
(``csrc/``) on CUDA tensors and runs its ``*_plain`` PyTorch twin on CPU
tensors. Every kernel launch is counted under the kernel's name
(:func:`launch_counts`, a view of the counters ``launch.<kernel>`` of
``utils.profiling``); the conv module's four forms count apart, as
``fused_conv_module`` (caller-side LayerNorm) and ``fused_conv_module_ln``
(in-kernel LayerNorm) with the folded batch norm, and
``fused_conv_module_layer`` and ``fused_conv_module_ln_layer`` with the
per-frame LayerNorm; the [B, H, T, dh] attention's two entries as
``relpos_attention`` (single pass) and ``relpos_attention_blockwise``
(streamed), and the Zipformer shared attention's as
``shared_rel_attention`` and ``shared_rel_attention_blockwise``; the beam
decoders' opt-in step kernels as ``joint_topm`` and ``lstm_cell_step``. The
[B, H, T, dh] attention and its twins are imported from
``ops.relpos_attention``: the single-pass entry shares the module's name,
so this package does not re-export them."""

from ..utils import profiling
from ._kernels import KERNELS
from .beam_topk import joint_topm, joint_topm_plain, topm_logsoftmax, topm_logsoftmax_plain
from .conformer_conv import fold_batch_norm, fused_conv_module, fused_conv_module_plain
from .ln_dense import (
    add_ln, add_ln_plain, ln_dense, ln_dense_add, ln_dense_add_plain, ln_dense_plain,
)
from .lstm_step import lstm_cell_step, lstm_cell_step_plain
from .relpos_attention import (
    relpos_attention_fused, relpos_attention_fused_packed, relpos_attention_fused_packed_plain,
    relpos_attention_fused_plain,
)
from .zipformer_attention import (
    shared_rel_attention, shared_rel_attention_blockwise, shared_rel_attention_blockwise_plain,
    shared_rel_attention_plain,
)


def reset_launch_counts():
    profiling.reset("launch.")


def launch_counts():
    """{kernel name: launches since the last reset}."""
    counted = profiling.counters()
    return {name: counted.get("launch." + name, 0) for name in KERNELS}


__all__ = [
    "KERNELS", "add_ln", "add_ln_plain", "fold_batch_norm", "fused_conv_module",
    "fused_conv_module_plain", "joint_topm", "joint_topm_plain", "launch_counts", "ln_dense",
    "ln_dense_add", "ln_dense_add_plain", "ln_dense_plain", "lstm_cell_step",
    "lstm_cell_step_plain", "relpos_attention_fused",
    "relpos_attention_fused_packed", "relpos_attention_fused_packed_plain",
    "relpos_attention_fused_plain", "reset_launch_counts", "shared_rel_attention",
    "shared_rel_attention_blockwise", "shared_rel_attention_blockwise_plain",
    "shared_rel_attention_plain", "topm_logsoftmax", "topm_logsoftmax_plain",
]
