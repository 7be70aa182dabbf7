"""Where the port's entry points run: the card unless the caller asks for
the CPU, and the fp32 matmul policy they set on it."""

import torch

__all__ = ["resolve_device", "set_fp32_matmul_policy"]


def resolve_device(device):
    """``device`` as a torch.device; None means CUDA. A CUDA device without
    a GPU raises: the entry points run on the card unless the caller asks
    for the CPU (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"load_model(device={str(device)!r}): no CUDA device is available; "
            "pass device=\"cpu\" to run on the CPU")
    return device


def set_fp32_matmul_policy():
    """bf16 GEMMs accumulate in fp32; fp32 GEMMs and convs stay fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
