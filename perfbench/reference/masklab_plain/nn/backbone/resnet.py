"""The two ResNet bodies the benchmark's configurations run: SE-ResNet34
(the road preset's backbone) and ResNet50 (the CLI's default).

Port of ``masklab_tpu/nn/backbone/resnet.py``:

  * ``_BN``, ``_SE``, ``CMBasicBlock``, ``CMResNet``, ``seresnet34``
    (``:65-166``, ``:498-501``), the classification_models pre-activation
    family: ``bn_data`` (a BatchNorm without scale) on the input, a 7x7
    stride-2 stem conv with padding 3, BatchNorm, relu (C1), a 3x3 stride-2
    max pool with padding 1 of -inf; stages of basic blocks (preact =
    relu(BN(x)); the shortcut x, or a 1x1 conv of preact on a stage's first
    unit; conv3x3 -> BN -> relu -> conv3x3 -> ChannelSE -> add); a final BN
    and relu (C5). C2-C4 are the pre-activation of the next stage's first
    unit. BatchNorm eps 2e-5.
  * ``BottleneckBlock``, ``_Stage``, ``ResNet``, ``resnet50``
    (``:244-296``, ``:385-465``), keras.applications' post-activation
    ResNet50: ``stem`` (7x7 stride 2, padding 3), ``stem_bn``, relu (C1),
    the max pool, stages ``stage2``..``stage5`` of 1x1 -> BN -> relu -> 3x3
    -> BN -> relu -> 1x1 -> BN bottlenecks, with a 1x1 conv + BN shortcut
    where the shape changes, added and relu'd; the stride on the first
    1x1, biased convs, eps 1.001e-5.

The reference's space-to-depth stem is a TPU form of the stem conv.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, Linear, conv2d, max_pool

CHANNELS = {'C1': 64, 'C2': 64, 'C3': 128, 'C4': 256, 'C5': 512}
RESNET50_CHANNELS = {'C1': 64, 'C2': 256, 'C3': 512, 'C4': 1024, 'C5': 2048}
STAGE_BLOCKS = (3, 4, 6, 3)   # basic blocks per stage of resnet34
_EPS = 2e-5
_SE_REDUCTION = 16


class _BN(nn.Module):
    """The reference's BatchNorm wrapper (its flax BatchNorm sits one scope
    down, as ``BatchNorm_0``)."""

    def __init__(self, channels: int, use_scale: bool = True,
                 eps: float = _EPS):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, eps, use_scale)

    def forward(self, x):
        return self.BatchNorm_0(x)


class _SE(nn.Module):
    """ChannelSE: spatial mean -> Dense c / r (bias) -> relu -> Dense c
    (bias) -> sigmoid, which scales the channels."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        hidden = max(1, channels // _SE_REDUCTION)
        self.fc1 = Linear(channels, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, channels, compute_dtype=dtype)

    def forward(self, x):
        se = torch.sigmoid(self.fc2(torch.relu(self.fc1(
            x.mean((-2, -1))))))
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

    def forward(self, x, generator=None):
        endpoints = {}
        x = self.conv0(self.bn_data(x).to(self.dtype))
        x = torch.relu(self.bn0(x))
        endpoints['C1'] = x
        x = max_pool(x, 3, 2, 1)
        for si, blocks in enumerate(STAGE_BLOCKS):
            for bi in range(blocks):
                x, preact = getattr(self, f'stage{si + 1}_unit{bi + 1}')(x)
                if bi == 0 and si > 0:
                    endpoints[f'C{si + 1}'] = preact
        endpoints['C5'] = torch.relu(self.bn1(x))
        return endpoints


def seresnet34(dtype=torch.float32) -> CMResNet:
    return CMResNet(dtype)




class BottleneckBlock(nn.Module):
    """Post-activation 1x1 -> 3x3 (grouped where ``groups`` > 1) -> 1x1
    bottleneck. The stride sits on the 3x3 (explicit (1, 1) padding), or
    on the first 1x1 with ``stride_first``."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 groups: int = 1, expansion: int = 4, bn_eps: float = 1e-5,
                 dtype=torch.float32, stride_first: bool = False,
                 conv_bias: bool = False):
        super().__init__()
        out_ch = filters * expansion
        s1, s3 = (stride, 1) if stride_first else (1, stride)
        self.Conv_0 = conv2d(in_ch, filters, 1, bias=conv_bias, stride=s1,
                             dtype=dtype)
        self._BN_0 = _BN(filters, eps=bn_eps)
        self.Conv_1 = conv2d(filters, filters, 3, bias=conv_bias, stride=s3,
                             padding=1, groups=groups, dtype=dtype)
        self._BN_1 = _BN(filters, eps=bn_eps)
        self.Conv_2 = conv2d(filters, out_ch, 1, bias=conv_bias, dtype=dtype)
        self._BN_2 = _BN(out_ch, eps=bn_eps)
        if in_ch != out_ch or stride != 1:
            self.Conv_3 = conv2d(in_ch, out_ch, 1, bias=conv_bias,
                                 stride=stride, dtype=dtype)
            self._BN_3 = _BN(out_ch, eps=bn_eps)

    def forward(self, x):
        y = torch.relu(self._BN_0(self.Conv_0(x)))
        y = torch.relu(self._BN_1(self.Conv_1(y)))
        y = self._BN_2(self.Conv_2(y))
        shortcut = self._BN_3(self.Conv_3(x)) if hasattr(self, 'Conv_3') else x
        return torch.relu(y + shortcut)


class _Stage(nn.Module):
    """``num_blocks`` bottleneck blocks (``BottleneckBlock_{i}``), the first
    one strided."""

    def __init__(self, num_blocks: int, in_ch: int, filters: int, stride: int,
                 groups: int, expansion: int, bn_eps: float, dtype,
                 **block_kwargs):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'BottleneckBlock_{i}', BottleneckBlock(
                in_ch if i == 0 else filters * expansion, filters,
                stride if i == 0 else 1, groups, expansion, bn_eps, dtype,
                **block_kwargs))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f'BottleneckBlock_{i}')(x)
        return x


class ResNet(nn.Module):
    """Post-activation ResNet body of bottleneck blocks; returns {'C1':
    ..., 'C5': ...} (NCHW), C2-C5 the stage outputs."""

    def __init__(self, stage_blocks=(3, 4, 6, 3),
                 stage_filters=(64, 128, 256, 512), groups: int = 1,
                 expansion: int = 4, bn_eps: float = 1e-5,
                 dtype=torch.float32, stride_first: bool = False,
                 conv_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stem = conv2d(3, 64, 7, bias=conv_bias, stride=2, padding=3,
                           dtype=dtype)
        self.stem_bn = _BN(64, eps=bn_eps)
        self.stages = len(stage_blocks)
        ch = 64
        for si, (blocks, filters) in enumerate(zip(stage_blocks,
                                                   stage_filters)):
            self.add_module(f'stage{si + 2}', _Stage(
                blocks, ch, filters, 1 if si == 0 else 2, groups, expansion,
                bn_eps, dtype, stride_first=stride_first,
                conv_bias=conv_bias))
            ch = filters * expansion

    def forward(self, x, generator=None):
        endpoints = {}
        x = torch.relu(self.stem_bn(self.stem(x.to(self.dtype))))
        endpoints['C1'] = x
        x = max_pool(x, 3, 2, 1)
        for si in range(self.stages):
            x = getattr(self, f'stage{si + 2}')(x)
            endpoints[f'C{si + 2}'] = x
        return endpoints


def resnet50(dtype=torch.float32) -> ResNet:
    """keras.applications' ResNet50 (v1): the stride on the first 1x1,
    biased convs (the stem's too), BatchNorm eps 1.001e-5."""
    return ResNet(stride_first=True, conv_bias=True, bn_eps=1.001e-5,
                  dtype=dtype)
