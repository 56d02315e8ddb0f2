"""MobileNet V1 backbone (alpha=1.0).

Port of ``masklab_tpu/nn/backbone/mobilenet.py``: endpoints C1..C5 are the
pointwise ReLU6 outputs of blocks 1/3/5/11/13 (strides 2..32). Stride-2 convs
use the Keras (0,1) zero-pad + VALID convention, depthwise convs are
``groups=C``, BatchNorm uses running statistics with eps 1e-3. The stem is a
plain stride-2 conv (the reference's space-to-depth stem is a TPU form of
the same conv).
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
        return torch.clamp(x, 0.0, 6.0)


class MobileNetV1(nn.Module):
    """Returns a dict of endpoints {'C1': ..., 'C5': ...} (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.stem = _ConvBN(3, 32, 3, stride=2, dtype=dtype)
        ch = 32
        for i, (out, stride) in enumerate(_BLOCKS, start=1):
            self.add_module(f'dw{i}', _ConvBN(ch, ch, 3, stride=stride,
                                              depthwise=True, dtype=dtype))
            self.add_module(f'pw{i}', _ConvBN(ch, out, 1, dtype=dtype))
            ch = out

    def forward(self, x):
        """x: float NCHW frames, cast here to the convs' dtype."""
        endpoints = {}
        x = self.stem(x.to(self.stem.Conv_0.weight.dtype))
        for i in range(1, len(_BLOCKS) + 1):
            x = getattr(self, f'pw{i}')(getattr(self, f'dw{i}')(x))
            if i in _ENDPOINTS:
                endpoints[_ENDPOINTS[i]] = x
        return endpoints
