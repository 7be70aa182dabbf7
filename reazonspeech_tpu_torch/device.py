"""Where the port's entry points run: the card unless the caller asks for
the CPU, and the fp32 matmul policy they set on it."""

import numpy as np
import torch

__all__ = ["host_to_device", "param_device", "resolve_device", "set_fp32_matmul_policy"]


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


def param_device(params):
    """The device of a parameter tree (that of its first tensor)."""
    while isinstance(params, (dict, list, tuple)):
        params = next(iter(params.values() if isinstance(params, dict) else params))
    return params.device


def host_to_device(array, device):
    """A host array as a tensor on ``device``: a copy (the caller may change
    its array), on CUDA through a fresh pinned buffer that is never written
    after the asynchronous copy is issued."""
    t = torch.from_numpy(np.array(array))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
