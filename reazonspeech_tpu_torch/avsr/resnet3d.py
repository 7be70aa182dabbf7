"""Video trunk: 3-D conv frontend + per-frame ResNet-18 (PyTorch).

The port of ``reazonspeech_tpu/avsr/resnet3d.py``. Architecture parity with
the reference trunk (pkg/avsr/src/avhubert/modeling_resnet.py:74-178):
Conv3d(1→64, k=(5,7,7), s=(1,2,2)) + BN + PReLU + MaxPool3d(k=(1,3,3),
s=(1,2,2)), then a [2,2,2,2] BasicBlock ResNet over each frame, global
average pool → 512-d per frame. BatchNorms run in inference mode
(statistics are params, filled by the checkpoint converter).

The tree keeps the JAX layouts (3-D conv ``w`` DHWIO, 2-D conv ``w`` HWIO)
and the activations stay channels-last (NDHWC, NHWC); the convolutions
permute at the call to ``F.conv3d`` / ``F.conv2d``. Everything runs in fp32.
"""

import math

import torch
import torch.nn.functional as F

from ..models.layers import batch_norm_infer, batch_norm_init, conv2d, conv2d_init

__all__ = ["init_resnet3d", "resnet3d_apply", "RESNET_OUT_DIM"]

RESNET_OUT_DIM = 512


def _prelu_init(ch, device):
    return {"alpha": torch.full((ch,), 0.25, device=device)}


def _prelu(p, x):
    """Per-channel PReLU over the last axis; a (1,)-shaped alpha is a scalar."""
    a = p["alpha"]
    if a.shape[0] == 1:
        a = a[0]
    return torch.where(x >= 0, x, a * x)


def _conv3d_init(gen, in_ch, out_ch, kernel, device):
    kd, kh, kw = kernel
    scale = 1.0 / math.sqrt(in_ch * kd * kh * kw)
    u = torch.rand((kd, kh, kw, in_ch, out_ch), generator=gen, device=device)
    return {"w": (u * 2.0 - 1.0) * scale}


def _conv3d(p, x, stride, padding):
    """x: NDHWC, ``w``: DHWIO, symmetric zero ``padding`` per spatial axis."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), p["w"].permute(4, 3, 0, 1, 2),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def _basic_block_init(gen, in_ch, out_ch, stride, device):
    p = {
        "conv1": conv2d_init(gen, in_ch, out_ch, 3, bias=False, device=device),
        "bn1": batch_norm_init(out_ch, device),
        "relu1": _prelu_init(out_ch, device),
        "conv2": conv2d_init(gen, out_ch, out_ch, 3, bias=False, device=device),
        "bn2": batch_norm_init(out_ch, device),
        "relu2": _prelu_init(out_ch, device),
    }
    if stride != 1 or in_ch != out_ch:
        p["down_conv"] = conv2d_init(gen, in_ch, out_ch, 1, bias=False, device=device)
        p["down_bn"] = batch_norm_init(out_ch, device)
    return p


def _basic_block(p, x, stride):
    same = ((1, 1), (1, 1))
    y = conv2d(p["conv1"], x, stride=stride, padding=same)
    y = _prelu(p["relu1"], batch_norm_infer(p["bn1"], y))
    y = conv2d(p["conv2"], y, stride=1, padding=same)
    y = batch_norm_infer(p["bn2"], y)
    identity = x
    if "down_conv" in p:
        identity = batch_norm_infer(p["down_bn"], conv2d(p["down_conv"], x, stride=stride))
    return _prelu(p["relu2"], y + identity)


def init_resnet3d(gen, relu_type="prelu", device="cpu"):
    """Random trunk weights drawn from the torch.Generator ``gen`` (the
    reference's distributions; the values differ from the JAX package's)."""
    del relu_type  # prelu params double as relu when alpha -> 0
    p = {
        "front_conv": _conv3d_init(gen, 1, 64, (5, 7, 7), device),
        "front_bn": batch_norm_init(64, device),
        "front_relu": _prelu_init(64, device),
    }
    stages = []
    in_ch = 64
    for out_ch, stride in [(64, 1), (128, 2), (256, 2), (512, 2)]:
        stages.append([
            _basic_block_init(gen, in_ch, out_ch, stride, device),
            _basic_block_init(gen, out_ch, out_ch, 1, device),
        ])
        in_ch = out_ch
    p["stages"] = stages
    return p


def resnet3d_apply(params, video):
    """video: [B, T, H, W] grayscale -> [B, T, 512] (fp32).

    The 3-D frontend mixes ±2 frames of temporal context; the ResNet trunk
    then runs per frame (time folded into batch, reference
    modeling_resnet.py:175-178).
    """
    b = video.shape[0]
    x = video.to(torch.float32)[..., None]  # [B, T, H, W, 1]
    x = _conv3d(params["front_conv"], x, (1, 2, 2), (2, 3, 3))
    x = _prelu(params["front_relu"], batch_norm_infer(params["front_bn"], x))
    # MaxPool3d k=(1,3,3) s=(1,2,2) pad (0,1,1); the padding is -inf
    x = F.max_pool3d(x.permute(0, 4, 1, 2, 3), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    x = x.permute(0, 2, 3, 4, 1)

    # fold time into batch for the 2-D trunk
    _, t2, h2, w2, c = x.shape
    x = x.reshape(b * t2, h2, w2, c)
    for blocks in params["stages"]:
        for bi, block in enumerate(blocks):
            # the first block of a widening stage downsamples spatially
            stride = 2 if (bi == 0 and "down_conv" in block) else 1
            x = _basic_block(block, x, stride)
    x = x.mean(dim=(1, 2))  # global average pool -> [B*T, 512]
    return x.reshape(b, t2, RESNET_OUT_DIM)
