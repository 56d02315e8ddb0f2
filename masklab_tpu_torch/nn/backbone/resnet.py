"""SE-ResNet34: the road preset's backbone.

Port of ``_BN``, ``_SE``, ``CMBasicBlock``, ``CMResNet`` and ``seresnet34``
(``masklab_tpu/nn/backbone/resnet.py:65-166``, ``:498-501``), the
classification_models pre-activation family:

  * ``bn_data`` (a BatchNorm without scale) on the input, a 7x7 stride-2
    stem conv with padding 3, BatchNorm, relu (C1), then a 3x3 stride-2 max
    pool with padding 1 of -inf;
  * stages of basic blocks: preact = relu(BN(x)); the shortcut is x, or a
    1x1 conv of preact on each stage's first unit; conv3x3 (stride, pad 1)
    -> BN -> relu -> conv3x3 (pad 1) -> ChannelSE -> add;
  * a final BN and relu (C5).

C2-C4 are the pre-activation of the next stage's first unit. BatchNorm eps
is 2e-5 throughout. The other resnets of the reference's zoo are not
ported yet (ROADMAP.md, Queue 1). The reference's space-to-depth stem is a
TPU form of the same conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, conv2d

CHANNELS = {'C1': 64, 'C2': 64, 'C3': 128, 'C4': 256, 'C5': 512}
STAGE_BLOCKS = (3, 4, 6, 3)   # basic blocks per stage of resnet34
_EPS = 2e-5
_SE_REDUCTION = 16


class _BN(nn.Module):
    """The reference's BatchNorm wrapper (its flax BatchNorm sits one scope
    down, as ``BatchNorm_0``)."""

    def __init__(self, channels: int, use_scale: bool = True):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, _EPS, use_scale)

    def forward(self, x):
        return self.BatchNorm_0(x)


class _SE(nn.Module):
    """ChannelSE: spatial mean -> Dense c / r (bias) -> relu -> Dense c
    (bias) -> sigmoid, which scales the channels."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        hidden = max(1, channels // _SE_REDUCTION)
        self.fc1 = nn.Linear(channels, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, channels, dtype=dtype)

    def forward(self, x):
        se = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean((-2, -1))))))
        return x * se[:, :, None, None]


class CMBasicBlock(nn.Module):
    """Pre-activation basic block with ChannelSE; returns (output,
    preact)."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 cut: str = 'pre', dtype=torch.float32):
        super().__init__()
        self.bn1 = _BN(in_ch)
        if cut == 'post':
            self.sc = conv2d(in_ch, filters, 1, bias=False, stride=stride,
                             dtype=dtype)
        self.conv1 = conv2d(in_ch, filters, 3, bias=False, stride=stride,
                            padding=1, dtype=dtype)
        self.bn2 = _BN(filters)
        self.conv2 = conv2d(filters, filters, 3, bias=False, padding=1,
                            dtype=dtype)
        self.se = _SE(filters, dtype)

    def forward(self, x):
        preact = torch.relu(self.bn1(x))
        shortcut = self.sc(preact) if hasattr(self, 'sc') else x
        y = torch.relu(self.bn2(self.conv1(preact)))
        return self.se(self.conv2(y)) + shortcut, preact


class CMResNet(nn.Module):
    """SE-ResNet34 body; returns a dict of endpoints {'C1': ..., 'C5': ...}
    (NCHW). Takes a float32 input: ``bn_data`` normalizes it before the
    cast to ``dtype``, as the reference's BatchNorm computes in float32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn_data = _BN(3, use_scale=False)
        self.conv0 = conv2d(3, 64, 7, bias=False, stride=2, padding=3,
                            dtype=dtype)
        self.bn0 = _BN(64)
        ch = 64
        for si, blocks in enumerate(STAGE_BLOCKS):
            filters = 64 * 2 ** si
            for bi in range(blocks):
                self.add_module(f'stage{si + 1}_unit{bi + 1}', CMBasicBlock(
                    ch, filters, 2 if (bi == 0 and si > 0) else 1,
                    'post' if bi == 0 else 'pre', dtype))
                ch = filters
        self.bn1 = _BN(ch)

    def forward(self, x):
        endpoints = {}
        x = self.conv0(self.bn_data(x).to(self.dtype))
        x = torch.relu(self.bn0(x))
        endpoints['C1'] = x
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for si, blocks in enumerate(STAGE_BLOCKS):
            for bi in range(blocks):
                x, preact = getattr(self, f'stage{si + 1}_unit{bi + 1}')(x)
                if bi == 0 and si > 0:
                    endpoints[f'C{si + 1}'] = preact
        endpoints['C5'] = torch.relu(self.bn1(x))
        return endpoints


def seresnet34(dtype=torch.float32) -> CMResNet:
    return CMResNet(dtype)
