"""MobileNet V2 backbone (alpha = 1.0).

Port of ``masklab_tpu/nn/backbone/mobilenetv2.py``: a 3x3 stride-2 stem,
seven stages of inverted residuals (1x1 expand -> BN -> ReLU6 -> 3x3
depthwise -> BN -> ReLU6 -> 1x1 project -> BN, plus the input where the
stride is 1 and the width unchanged), then a 1x1 conv to 1280, BN and ReLU6
(C5). C1-C4 are the inputs of the first blocks of stages 1, 2, 3 and 5
(strides 2 to 16). BatchNorm eps 1e-3, momentum 0.999. Stride-2 convs pad
as XLA's 'SAME' does (``pad_same_s2``, from each map's parity): the
reference's space-to-depth stem on even maps is a TPU form of that conv.
ReLU6 is ``mobilenet.relu6`` (one ``clamp``, the reference's tie gradient).
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, conv2d, pad_same_s2
from .mobilenet import relu6

# (expansion t, channels, repeats, first stride)
_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
# stage whose FIRST block's input is the endpoint (before its stride)
_TAPS = {1: 'C1', 2: 'C2', 3: 'C3', 5: 'C4'}
CHANNELS = {'C1': 16, 'C2': 24, 'C3': 32, 'C4': 96, 'C5': 1280}
_TOP = 1280


class _BN(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, 1e-3, momentum=0.999)

    def forward(self, x, residual=None):
        return self.BatchNorm_0(x, residual=residual)


def _depthwise(ch: int, stride: int, dtype) -> nn.Module:
    return conv2d(ch, ch, 3, bias=False, stride=stride,
                  padding=1 if stride == 1 else 0, groups=ch, dtype=dtype)


class _InvertedResidual(nn.Module):
    """Named as the reference's auto-numbered convs and BatchNorms: the
    expansion (``Conv_0`` / ``_BN_0``) exists only where t != 1."""

    def __init__(self, in_ch: int, out_ch: int, expansion: int, stride: int,
                 dtype=torch.float32):
        super().__init__()
        hidden = in_ch * expansion
        self.stride = stride
        self.residual = stride == 1 and in_ch == out_ch
        layers = []
        if expansion != 1:
            layers.append(('expand', conv2d(in_ch, hidden, 1, bias=False,
                                            dtype=dtype), hidden))
        layers.append(('depthwise', _depthwise(hidden, stride, dtype),
                       hidden))
        layers.append(('project', conv2d(hidden, out_ch, 1, bias=False,
                                         dtype=dtype), out_ch))
        self.kinds = [kind for kind, _, _ in layers]
        for i, (_, conv, ch) in enumerate(layers):
            self.add_module(f'Conv_{i}', conv)
            self.add_module(f'_BN_{i}', _BN(ch))

    def forward(self, x):
        inputs = x
        for i, kind in enumerate(self.kinds):
            if kind == 'depthwise' and self.stride == 2:
                x = pad_same_s2(x)
            x = getattr(self, f'Conv_{i}')(x)
            if kind == 'project':
                return getattr(self, f'_BN_{i}')(
                    x, residual=inputs if self.residual else None)
            x = relu6(getattr(self, f'_BN_{i}')(x))


class MobileNetV2(nn.Module):
    """Returns a dict of endpoints {'C1': ..., 'C5': ...} (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = conv2d(3, 32, 3, bias=False, stride=2, dtype=dtype)
        self.stem_bn = _BN(32)
        in_ch = 32
        for si, (t, c, reps, stride) in enumerate(_CFG):
            for bi in range(reps):
                self.add_module(f'stage{si}_block{bi}', _InvertedResidual(
                    in_ch, c, t, stride if bi == 0 else 1, dtype))
                in_ch = c
        self.top_conv = conv2d(in_ch, _TOP, 1, bias=False, dtype=dtype)
        self.top_bn = _BN(_TOP)

    def forward(self, x, generator=None):
        endpoints = {}
        x = relu6(self.stem_bn(self.stem(pad_same_s2(x.to(self.dtype)))))
        for si, (_, _, reps, _) in enumerate(_CFG):
            for bi in range(reps):
                if bi == 0 and si in _TAPS:
                    endpoints[_TAPS[si]] = x
                x = getattr(self, f'stage{si}_block{bi}')(x)
        endpoints['C5'] = relu6(self.top_bn(self.top_conv(x)))
        return endpoints
