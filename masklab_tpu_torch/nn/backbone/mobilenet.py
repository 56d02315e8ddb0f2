"""MobileNet V1 backbone (alpha=1.0).

Port of ``masklab_tpu/nn/backbone/mobilenet.py``: endpoints C1..C5 are the
pointwise ReLU6 outputs of blocks 1/3/5/11/13 (strides 2..32). Stride-2 convs
use the Keras (0,1) zero-pad + VALID convention, depthwise convs are
``groups=C``, BatchNorm has eps 1e-3. ReLU6 is the reference's ``min(max(x,
0), 6)``: one ``clamp`` forward, with that form's gradient, halved at a tie (x
exactly 0 or 6, e.g. a dead channel under train-mode BatchNorm), which
``clamp``'s own gradient is not. The stem is a plain stride-2 conv (the
reference's space-to-depth stem is a TPU form of the same conv).
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, conv2d, pad_valid_s2

# (pointwise_channels, depthwise_stride) for the 13 separable blocks
_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
# block index (1-based) -> endpoint name
_ENDPOINTS = {1: 'C1', 3: 'C2', 5: 'C3', 11: 'C4', 13: 'C5'}
CHANNELS = {'C1': 64, 'C2': 128, 'C3': 256, 'C4': 512, 'C5': 1024}


class _ReLU6(torch.autograd.Function):
    """``clamp(x, 0, 6)`` with the gradient of ``min(max(x, 0), 6)`` under
    the reference's tie rule: 1 inside (0, 6), 1/2 at exactly 0 or 6, 0
    outside."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        inside = ((x >= 0) & (x <= 6)).to(g.dtype)
        tie = ((x == 0) | (x == 6)).to(g.dtype)
        return g * (inside - 0.5 * tie)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return _ReLU6.apply(x)


class _ConvBN(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 depthwise: bool = False, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.Conv_0 = conv2d(in_ch, out_ch, kernel, bias=False, stride=stride,
                             padding=0 if stride == 2 else (kernel - 1) // 2,
                             groups=in_ch if depthwise else 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(out_ch)

    def forward(self, x):
        if self.stride == 2:
            x = pad_valid_s2(x)
        x = self.BatchNorm_0(self.Conv_0(x))
        return relu6(x)


class MobileNetV1(nn.Module):
    """Returns a dict of endpoints {'C1': ..., 'C5': ...} (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = _ConvBN(3, 32, 3, stride=2, dtype=dtype)
        ch = 32
        for i, (out, stride) in enumerate(_BLOCKS, start=1):
            self.add_module(f'dw{i}', _ConvBN(ch, ch, 3, stride=stride,
                                              depthwise=True, dtype=dtype))
            self.add_module(f'pw{i}', _ConvBN(ch, out, 1, dtype=dtype))
            ch = out

    def forward(self, x, generator=None):
        """x: float NCHW frames, cast here to the convs' dtype."""
        endpoints = {}
        x = self.stem(x.to(self.dtype))
        for i in range(1, len(_BLOCKS) + 1):
            x = getattr(self, f'pw{i}')(getattr(self, f'dw{i}')(x))
            if i in _ENDPOINTS:
                endpoints[_ENDPOINTS[i]] = x
        return endpoints
