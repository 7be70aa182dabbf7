"""The products of the plain reference, in one of two precisions.

``Numerics("fp32")`` is the reference: fp32 operands, fp32 accumulation,
TF32 off. ``Numerics("fp8")`` is the control: both operands of every
product the configuration runs in bf16 (the dense layers, the attention
products, the convolutions of the subsampling) rounded to fp8 e4m3 with a
per-tensor scale first, then multiplied in fp32. Elementwise work,
normalisation, softmax and depthwise taps stay fp32 on both.
"""

import torch
import torch.nn.functional as F

__all__ = ["Numerics", "no_tf32"]

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def no_tf32():
    """fp32 products stay fp32 on the card (TF32 would round to 10 bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    def __init__(self, precision="fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r} is not fp32 or fp8")
        self.precision = precision
        no_tf32()

    def q(self, x):
        """x in fp32; for the control, rounded to fp8 e4m3 at a per-tensor
        scale that maps its largest magnitude to the largest finite fp8."""
        x = x.to(torch.float32)
        if self.precision == "fp32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def dense(self, p, x):
        y = self.q(x) @ self.q(p["w"])
        return y + p["b"] if "b" in p else y

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def conv2d(self, p, x, stride, padding=(0, 0, 0, 0), groups=1):
        """x [B, H, W, C] channels-last, w HWIO; ``padding`` (left, right,
        top, bottom) zeros."""
        xc = F.pad(x.permute(0, 3, 1, 2), padding)
        w = p["w"].permute(3, 2, 0, 1)
        y = F.conv2d(self.q(xc), self.q(w), stride=stride, groups=groups)
        return (y + p["b"][None, :, None, None]).permute(0, 2, 3, 1)
