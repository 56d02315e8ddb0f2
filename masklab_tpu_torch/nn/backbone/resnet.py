"""The ResNet family: SE-ResNet34 (the road preset's backbone), ResNet50,
SE-ResNet50, ResNeXt50 (the training bench's), SE-ResNeXt50, ResNet50V2 and
ResNet101V2.

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
  * ``BottleneckBlock``, ``_Stage``, ``ResNet`` (``:244-296``,
    ``:385-459``), the post-activation family: ``stem`` (7x7 stride 2,
    padding 3), ``stem_bn``, relu (C1), the max pool, stages ``stage2``..
    ``stage5`` of 1x1 -> BN -> relu -> 3x3 -> BN -> relu -> 1x1 -> BN
    bottlenecks, with a 1x1 conv + BN shortcut where the shape changes,
    added and relu'd. resnet50 (``:462-465``): the stride on the first
    1x1, biased convs, eps 1.001e-5. seresnet50 (``:504-508``): the stride
    on the first 1x1, ChannelSE before the add, eps 1e-5. resnext50 and
    seresnext50 (``:491-495``, ``:511-519``): inner widths 128..1024,
    expansion 2, a 32-group 3x3 carrying the stride; seresnext50 adds
    ChannelSE and taps C2-C4 at the relu after the first 1x1 of the NEXT
    stage's first block (``inner_taps``).
  * ``V2Block``, ``ResNetV2``, resnet50v2, resnet101v2 (``:299-383``,
    ``:468-482``): keras_applications' pre-activation v2 stacks with the
    stride on each stack's last block and mid-stack taps.

The grouped 3x3 is a native ``groups=32`` conv: the reference's
block-diagonal dense conv is a TPU form of it, and its grouped kernel
[3, 3, C_in/32, out] maps to the conv's [out, C_in/32, 3, 3] by the bridge's
HWIO -> OIHW rule. The reference's space-to-depth stem is a TPU form of the
stem conv. resnet101 (``:485``) is not in the reference's registry, and not
here.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import spatial
from ..layers import BatchNorm, Linear, conv2d, max_pool

CHANNELS = {'C1': 64, 'C2': 64, 'C3': 128, 'C4': 256, 'C5': 512}
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

    def forward(self, x, act=None, residual=None):
        return self.BatchNorm_0(x, act, residual)


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
            spatial.mean_hw(x, self)))))
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
        preact = self.bn1(x, act='relu')
        shortcut = self.sc(preact) if hasattr(self, 'sc') else x
        y = self.bn2(self.conv1(preact), act='relu')
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
        x = self.bn0(x, act='relu')
        endpoints['C1'] = x
        x = max_pool(x, 3, 2, 1, site=self)
        for si, blocks in enumerate(STAGE_BLOCKS):
            for bi in range(blocks):
                x, preact = getattr(self, f'stage{si + 1}_unit{bi + 1}')(x)
                if bi == 0 and si > 0:
                    endpoints[f'C{si + 1}'] = preact
        endpoints['C5'] = self.bn1(x, act='relu')
        return endpoints


def seresnet34(dtype=torch.float32) -> CMResNet:
    return CMResNet(dtype)




class BottleneckBlock(nn.Module):
    """Post-activation 1x1 -> 3x3 (grouped where ``groups`` > 1) -> 1x1
    bottleneck; returns (output, the relu after the first 1x1). The stride
    sits on the 3x3 (explicit (1, 1) padding), or on the first 1x1 with
    ``stride_first``; ``use_se`` puts a ChannelSE (``_SE_0``) before the
    add. Without it the last BatchNorm takes the shortcut and the relu
    (K5's residual epilogue in eval), so the shortcut is computed before
    it."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 groups: int = 1, expansion: int = 4, bn_eps: float = 1e-5,
                 dtype=torch.float32, use_se: bool = False,
                 stride_first: bool = False, conv_bias: bool = False):
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
        if use_se:
            self._SE_0 = _SE(out_ch, dtype)
        if in_ch != out_ch or stride != 1:
            self.Conv_3 = conv2d(in_ch, out_ch, 1, bias=conv_bias,
                                 stride=stride, dtype=dtype)
            self._BN_3 = _BN(out_ch, eps=bn_eps)

    def forward(self, x):
        relu1 = self._BN_0(self.Conv_0(x), act='relu')
        y = self._BN_1(self.Conv_1(relu1), act='relu')
        y = self.Conv_2(y)
        use_se = hasattr(self, '_SE_0')
        if use_se:
            y = self._SE_0(self._BN_2(y))
        shortcut = self._BN_3(self.Conv_3(x)) if hasattr(self, 'Conv_3') else x
        if use_se:
            return torch.relu(y + shortcut), relu1
        return self._BN_2(y, act='relu', residual=shortcut), relu1


class _Stage(nn.Module):
    """``num_blocks`` bottleneck blocks (``BottleneckBlock_{i}``), the first
    one strided; returns (output, the first block's relu after its first
    1x1)."""

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
        relu1_first = None
        for i in range(self.num_blocks):
            x, relu1 = getattr(self, f'BottleneckBlock_{i}')(x)
            if i == 0:
                relu1_first = relu1
        return x, relu1_first


class ResNet(nn.Module):
    """Post-activation ResNet / ResNeXt / SE-ResNet body of bottleneck
    blocks; returns {'C1': ..., 'C5': ...} (NCHW). C2-C5 are the stage
    outputs, except with ``inner_taps`` (seresnext50): C2-C4 are then the
    relu after the first 1x1 of the NEXT stage's first block, at the same
    stride since that block's stride sits on its 3x3."""

    def __init__(self, stage_blocks=(3, 4, 6, 3),
                 stage_filters=(64, 128, 256, 512), groups: int = 1,
                 expansion: int = 4, bn_eps: float = 1e-5,
                 dtype=torch.float32, use_se: bool = False,
                 stride_first: bool = False, conv_bias: bool = False,
                 inner_taps: bool = False):
        super().__init__()
        self.dtype = dtype
        self.inner_taps = inner_taps
        self.stem = conv2d(3, 64, 7, bias=conv_bias, stride=2, padding=3,
                           dtype=dtype)
        self.stem_bn = _BN(64, eps=bn_eps)
        self.stages = len(stage_blocks)
        ch = 64
        for si, (blocks, filters) in enumerate(zip(stage_blocks,
                                                   stage_filters)):
            self.add_module(f'stage{si + 2}', _Stage(
                blocks, ch, filters, 1 if si == 0 else 2, groups, expansion,
                bn_eps, dtype, use_se=use_se, stride_first=stride_first,
                conv_bias=conv_bias))
            ch = filters * expansion

    def forward(self, x, generator=None):
        endpoints = {}
        x = self.stem_bn(self.stem(x.to(self.dtype)), act='relu')
        endpoints['C1'] = x
        x = max_pool(x, 3, 2, 1, site=self)
        for si in range(self.stages):
            x, relu1 = getattr(self, f'stage{si + 2}')(x)
            if self.inner_taps and si >= 1:
                endpoints[f'C{si + 1}'] = relu1
            endpoints[f'C{si + 2}'] = x
        return endpoints


def resnet50(dtype=torch.float32) -> ResNet:
    """keras.applications' ResNet50 (v1): the stride on the first 1x1,
    biased convs (the stem's too), BatchNorm eps 1.001e-5."""
    return ResNet(stride_first=True, conv_bias=True, bn_eps=1.001e-5,
                  dtype=dtype)


def seresnet50(dtype=torch.float32) -> ResNet:
    """senet.py's SE-ResNet50: the stride on the first 1x1, ChannelSE
    before the add, BatchNorm eps 1e-5."""
    return ResNet(use_se=True, stride_first=True, bn_eps=1e-5, dtype=dtype)


def seresnext50(dtype=torch.float32) -> ResNet:
    """senet.py's SE-ResNeXt50: resnext50's grouped body with ChannelSE,
    BatchNorm eps 1e-5, and the inner C2-C4 taps."""
    return ResNet(stage_filters=(128, 256, 512, 1024), groups=32,
                  expansion=2, use_se=True, bn_eps=1e-5, inner_taps=True,
                  dtype=dtype)


def resnext50(dtype=torch.float32) -> ResNet:
    """ResNeXt-50 32x4d: inner widths 128..1024, 32 groups, expansion 2."""
    return ResNet(stage_filters=(128, 256, 512, 1024), groups=32,
                  expansion=2, bn_eps=1.001e-5, dtype=dtype)


_V2_EPS = 1.001e-5


class V2Block(nn.Module):
    """keras_applications' resnet_v2 block: preact = relu(BN(x)); the
    shortcut is a biased 1x1 conv of preact (a stack's first block), x
    subsampled by the stride (a strided last block: a 1-wide max pool), or
    x; 1x1 -> BN -> relu (``1_relu``) -> 3x3 (the stride, explicit (1, 1)
    padding) -> BN -> relu -> biased 1x1 expanding; add. Returns (output,
    {'preact_relu': ..., '1_relu': ...}), the activations the reference's
    endpoint table addresses."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 conv_shortcut: bool = False, dtype=torch.float32):
        super().__init__()
        out_ch = filters * 4
        self.stride = stride
        self.preact_bn = _BN(in_ch, eps=_V2_EPS)
        if conv_shortcut:
            self.conv0 = conv2d(in_ch, out_ch, 1, stride=stride, dtype=dtype)
        self.conv1 = conv2d(in_ch, filters, 1, bias=False, dtype=dtype)
        self.bn1 = _BN(filters, eps=_V2_EPS)
        self.conv2 = conv2d(filters, filters, 3, bias=False, stride=stride,
                            padding=1, dtype=dtype)
        self.bn2 = _BN(filters, eps=_V2_EPS)
        self.conv3 = conv2d(filters, out_ch, 1, dtype=dtype)

    def forward(self, x):
        pre = self.preact_bn(x, act='relu')
        if hasattr(self, 'conv0'):
            shortcut = self.conv0(pre)
        elif self.stride > 1:
            sp = spatial.active()
            shortcut = (x[:, :, ::self.stride, ::self.stride] if sp is None
                        else spatial.subsample_rows(sp, self, x, self.stride))
        else:
            shortcut = x
        y = self.bn1(self.conv1(pre), act='relu')
        taps = {'preact_relu': pre, '1_relu': y}
        y = self.bn2(self.conv2(y), act='relu')
        return self.conv3(y) + shortcut, taps


class ResNetV2(nn.Module):
    """keras_applications' resnet_v2 body: a biased 7x7 stride-2 stem (C1,
    before any norm), a zero-padded 3x3 stride-2 max pool (the stem's
    output can be negative, so the zeros take part), stacks of
    ``stage{k}_block{j}`` with the stride on each stack's last block but
    the last stack's, then ``post_bn`` and relu (C5). ``taps`` maps C2-C4
    to (stack, 0-based block, 'preact_relu' or '1_relu')."""

    def __init__(self, stage_blocks=(3, 4, 6, 3), taps=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage_blocks = tuple(stage_blocks)
        self.tap_of = {tuple(v): k for k, v in (taps or {}).items()}
        self.stem = conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype)
        ch = 64
        for si, blocks in enumerate(self.stage_blocks):
            filters = 64 * 2 ** si
            last_stride = 2 if si < len(self.stage_blocks) - 1 else 1
            for bi in range(blocks):
                self.add_module(f'stage{si + 2}_block{bi + 1}', V2Block(
                    ch, filters, last_stride if bi == blocks - 1 else 1,
                    conv_shortcut=bi == 0, dtype=dtype))
                ch = filters * 4
        self.post_bn = _BN(ch, eps=_V2_EPS)

    def forward(self, x, generator=None):
        endpoints = {}
        x = self.stem(x.to(self.dtype))
        endpoints['C1'] = x
        x = max_pool(x, 3, 2, 1, site=self, zero_pad=True)
        for si, blocks in enumerate(self.stage_blocks):
            for bi in range(blocks):
                x, taps = getattr(self, f'stage{si + 2}_block{bi + 1}')(x)
                for kind, t in taps.items():
                    name = self.tap_of.get((si, bi, kind))
                    if name:
                        endpoints[name] = t
        endpoints['C5'] = self.post_bn(x, act='relu')
        return endpoints


def resnet50v2(dtype=torch.float32) -> ResNetV2:
    """Taps conv{2,3,4}_block{3,4,4}_preact_relu: C4 mid-stack, at block 4
    of 6."""
    return ResNetV2(taps={'C2': (0, 2, 'preact_relu'),
                          'C3': (1, 3, 'preact_relu'),
                          'C4': (2, 3, 'preact_relu')}, dtype=dtype)


def resnet101v2(dtype=torch.float32) -> ResNetV2:
    """Taps conv{2,3,4}_block{3,4,23}_1_relu: the 64/128/256-channel
    activation inside each stack's last block."""
    return ResNetV2(stage_blocks=(3, 4, 23, 3),
                    taps={'C2': (0, 2, '1_relu'), 'C3': (1, 3, '1_relu'),
                          'C4': (2, 22, '1_relu')}, dtype=dtype)


# endpoint channels of each body
RESNET50_CHANNELS = {'C1': 64, 'C2': 256, 'C3': 512, 'C4': 1024, 'C5': 2048}
RESNET101V2_CHANNELS = {'C1': 64, 'C2': 64, 'C3': 128, 'C4': 256,
                        'C5': 2048}
