"""Kernel-backed ops. Each public op launches a hand-written CUDA kernel
(``csrc/``) on CUDA tensors and runs its ``*_plain`` PyTorch twin on CPU
tensors. Every kernel launch is counted under the kernel's name
(:func:`launch_counts`); the conv module's two forms count apart, as
``fused_conv_module`` (caller-side LayerNorm) and ``fused_conv_module_ln``
(in-kernel LayerNorm), and the Zipformer shared attention's two entries
as ``shared_rel_attention`` (single pass) and
``shared_rel_attention_blockwise`` (streamed)."""

from ._kernels import KERNELS, launches
from .beam_topk import topm_logsoftmax, topm_logsoftmax_plain
from .conformer_conv import fold_batch_norm, fused_conv_module, fused_conv_module_plain
from .ln_dense import (
    add_ln, add_ln_plain, ln_dense, ln_dense_add, ln_dense_add_plain, ln_dense_plain,
)
from .relpos_attention import (
    relpos_attention_fused, relpos_attention_fused_packed, relpos_attention_fused_packed_plain,
    relpos_attention_fused_plain,
)
from .zipformer_attention import (
    shared_rel_attention, shared_rel_attention_blockwise, shared_rel_attention_blockwise_plain,
    shared_rel_attention_plain,
)


def reset_launch_counts():
    for name in KERNELS:
        launches[name] = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return dict(launches)


__all__ = [
    "KERNELS", "add_ln", "add_ln_plain", "fold_batch_norm", "fused_conv_module",
    "fused_conv_module_plain", "launch_counts", "ln_dense", "ln_dense_add",
    "ln_dense_add_plain", "ln_dense_plain", "relpos_attention_fused",
    "relpos_attention_fused_packed", "relpos_attention_fused_packed_plain",
    "relpos_attention_fused_plain", "reset_launch_counts", "shared_rel_attention",
    "shared_rel_attention_blockwise", "shared_rel_attention_blockwise_plain",
    "shared_rel_attention_plain", "topm_logsoftmax", "topm_logsoftmax_plain",
]
