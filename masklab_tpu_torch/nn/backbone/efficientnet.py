"""EfficientNet B2 / B3 / B4 backbones.

Port of ``masklab_tpu/nn/backbone/efficientnet.py``: a 3x3 stride-2 stem,
seven stages of MBConv blocks (1x1 expand -> BN -> swish, then a k x k
depthwise conv -> BN -> swish, squeeze-excite by two biased 1x1 convs on
the spatial mean, a 1x1 projection -> BN, and the input added back where
the stride is 1 and the width unchanged), then a 1x1 conv, BN and swish
(C5). C1-C4 are the expand activations of the first blocks of stages 1, 2,
3 and 5. Widths and repeats scale by ``_round_filters`` /
``_round_repeats``. BatchNorm eps 1e-3, momentum 0.99. Stride-2 convs pad
as XLA's 'SAME' does (``pad_same_s2``, from each map's parity and the
kernel size); the reference's space-to-depth stem is a TPU form of that
conv.

Drop-connect (stochastic depth on the residual branch, a rate growing
linearly with the block's index up to 0.2) runs only in train mode and
only when the caller passes a ``torch.Generator`` to ``forward``: each
sample's branch is kept with probability 1 - rate and then scaled by 1 /
(1 - rate), as flax's ``Dropout`` with ``broadcast_dims=(1, 2, 3)``. Without
a generator, train mode is deterministic, as the reference without a
'dropout' rng.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiling import span
from .. import spatial
from ..layers import BatchNorm, conv2d, pad_same_s2

# (expand_ratio, channels, repeats, stride, kernel)
_BASE_BLOCKS = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_TAPS = {1: 'C1', 2: 'C2', 3: 'C3', 5: 'C4'}
# (width, depth) coefficients
_VARIANTS = {'efficientnetb2': (1.1, 1.2), 'efficientnetb3': (1.2, 1.4),
             'efficientnetb4': (1.4, 1.8)}
CHANNELS = {
    'efficientnetb2': {'C1': 96, 'C2': 144, 'C3': 288, 'C4': 720,
                       'C5': 1408},
    'efficientnetb3': {'C1': 144, 'C2': 192, 'C3': 288, 'C4': 816,
                       'C5': 1536},
    'efficientnetb4': {'C1': 144, 'C2': 192, 'C3': 336, 'C4': 960,
                       'C5': 1792},
}


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class _BN(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels, 1e-3)

    def forward(self, x, act=None, residual=None):
        return self.BatchNorm_0(x, act, residual)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: torch.Generator, sync=None) -> torch.Tensor:
    """Keep each sample's ``x`` with probability 1 - rate, scaled by 1 /
    (1 - rate); zero it otherwise. The draw is one uniform per sample from
    ``generator`` on its own device, compared with the keep probability.
    With ``sync`` (a data-parallel group's ``nn.sync.Ranks``), every rank
    draws for the global batch from the same generator and keeps its own
    rows."""
    keep = 1.0 - rate
    n = x.shape[0]
    world, rank = (1, 0) if sync is None else (sync.world, sync.rank)
    u = torch.rand(n * world, generator=generator,
                   device=generator.device)[rank * n:(rank + 1) * n]
    mask = (u < keep).to(x.device)[:, None, None, None]
    return torch.where(mask, x / keep, torch.zeros_like(x))


class _MBConv(nn.Module):
    """Named as the reference's auto-numbered layers: ``Conv_0`` /
    ``_BN_0`` the expansion (t != 1 only), then the depthwise conv and its
    BN, the two squeeze-excite convs, the projection and its BN. Returns
    (output, the expand activation)."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int,
                 kernel: int, drop_rate: float = 0.0, se_ratio: float = 0.25,
                 dtype=torch.float32):
        super().__init__()
        expanded = in_ch * expand
        self.expand, self.stride, self.kernel = expand, stride, kernel
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate
        self.sync = None                # nn.sync.synchronized sets it
        se_ch = max(1, int(in_ch * se_ratio))
        convs = []
        if expand != 1:
            convs.append(conv2d(in_ch, expanded, 1, bias=False, dtype=dtype))
        convs += [
            conv2d(expanded, expanded, kernel, bias=False, stride=stride,
                   padding=(kernel - 1) // 2 if stride == 1 else 0,
                   groups=expanded, dtype=dtype),
            conv2d(expanded, se_ch, 1, dtype=dtype),
            conv2d(se_ch, expanded, 1, dtype=dtype),
            conv2d(expanded, out_ch, 1, bias=False, dtype=dtype)]
        for i, conv in enumerate(convs):
            self.add_module(f'Conv_{i}', conv)
        norms = ([expanded] if expand != 1 else []) + [expanded, out_ch]
        for i, ch in enumerate(norms):
            self.add_module(f'_BN_{i}', _BN(ch))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        inputs = x
        c = b = 0
        if self.expand != 1:
            with span('mbconv:expand'):
                x = self._BN_0(self.Conv_0(x), act='silu')
            c = b = 1
        tap = x
        with span('mbconv:depthwise'):
            if self.stride == 2:
                x = pad_same_s2(x, self.kernel)
            x = getattr(self, f'_BN_{b}')(getattr(self, f'Conv_{c}')(x),
                                          act='silu')
        with span('mbconv:se'):
            se = spatial.mean_hw(x, self, keepdim=True)
            se = F.silu(getattr(self, f'Conv_{c + 1}')(se))
            x = x * torch.sigmoid(getattr(self, f'Conv_{c + 2}')(se))
        with span('mbconv:project'):
            x = getattr(self, f'Conv_{c + 3}')(x)
            norm = getattr(self, f'_BN_{b + 1}')
            if (self.residual and self.drop_rate > 0.0 and self.training
                    and generator is not None):
                return drop_connect(norm(x), self.drop_rate, generator,
                                    self.sync) + inputs, tap
            return norm(x, residual=inputs if self.residual else None), tap


class EfficientNet(nn.Module):
    """Returns a dict of endpoints {'C1': ..., 'C5': ...} (NCHW)."""

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 drop_connect_rate: float = 0.2, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        stem_ch = _round_filters(32, width)
        self.stem = conv2d(3, stem_ch, 3, bias=False, stride=2, dtype=dtype)
        self.stem_bn = _BN(stem_ch)
        in_ch = stem_ch
        total = sum(_round_repeats(r, depth) for _, _, r, _, _ in
                    _BASE_BLOCKS)
        self.blocks = []                # (stage, block) in order
        for si, (expand, ch, repeats, stride, kernel) in enumerate(
                _BASE_BLOCKS):
            out_ch = _round_filters(ch, width)
            for bi in range(_round_repeats(repeats, depth)):
                # linear stochastic-depth schedule over the global index
                drop = drop_connect_rate * len(self.blocks) / total
                self.add_module(f'stage{si}_block{bi}', _MBConv(
                    in_ch, out_ch, expand, stride if bi == 0 else 1, kernel,
                    drop_rate=drop, dtype=dtype))
                self.blocks.append((si, bi))
                in_ch = out_ch
        top_ch = _round_filters(1280, width)
        self.top_conv = conv2d(in_ch, top_ch, 1, bias=False, dtype=dtype)
        self.top_bn = _BN(top_ch)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws drop-connect in train mode; without it the
        forward is deterministic."""
        endpoints = {}
        x = self.stem_bn(self.stem(pad_same_s2(x.to(self.dtype))),
                         act='silu')
        for si, bi in self.blocks:
            x, tap = getattr(self, f'stage{si}_block{bi}')(x, generator)
            if bi == 0 and si in _TAPS:
                endpoints[_TAPS[si]] = tap
        endpoints['C5'] = self.top_bn(self.top_conv(x), act='silu')
        return endpoints


def efficientnet(name: str, dtype=torch.float32) -> EfficientNet:
    width, depth = _VARIANTS[name]
    return EfficientNet(width, depth, dtype=dtype)
