"""Kernel-backed ops. Each public op launches a hand-written CUDA kernel
(``csrc/``) on CUDA tensors and runs its ``*_plain`` PyTorch twin on CPU
tensors; each keeps a ``launches`` counter of kernel launches."""

from .beam_topk import topm_logsoftmax, topm_logsoftmax_plain
from .conformer_conv import fold_batch_norm, fused_conv_module, fused_conv_module_plain
from .relpos_attention import relpos_attention_fused, relpos_attention_fused_plain

KERNEL_OPS = (relpos_attention_fused, fused_conv_module, topm_logsoftmax)


def reset_launch_counts():
    for op in KERNEL_OPS:
        op.launches = 0


def launch_counts():
    return {op.__name__: op.launches for op in KERNEL_OPS}


__all__ = [
    "KERNEL_OPS", "fold_batch_norm", "fused_conv_module", "fused_conv_module_plain",
    "launch_counts", "relpos_attention_fused", "relpos_attention_fused_plain",
    "reset_launch_counts", "topm_logsoftmax", "topm_logsoftmax_plain",
]
