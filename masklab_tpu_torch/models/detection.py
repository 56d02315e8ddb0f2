"""Detection path: FPN and the classification / box-regression heads.

Port of ``masklab_tpu/models/detection.py:30-116``. Heads take the NCHW
feature list in ascending-stride order and return rows in the reference's
[B, sum(H*W*A), C] order (row-major over y, x, anchor; levels concatenated),
so row i lines up with prior i.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..nn.layers import HeadBlock, conv2d, same_conv
from ..ops.resize import resize_spatial


class FeaturePyramid(nn.Module):
    """Top-down FPN: 1x1 lateral + align-corners upsample-add, then a 3x3
    output conv per level (no norm, no activation)."""

    def __init__(self, in_channels: Sequence[int], num_features: int = 256,
                 dtype=torch.float32):
        super().__init__()
        for idx, ch in enumerate(reversed(list(in_channels))):
            self.add_module(f'lateral_{idx}',
                            conv2d(ch, num_features, 1, dtype=dtype))
            self.add_module(f'output_{idx}',
                            same_conv(num_features, num_features, 3,
                                      dtype=dtype))
        self.num_levels = len(in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outputs, prev = [], None
        for idx, head in enumerate(inputs[::-1]):
            lateral = getattr(self, f'lateral_{idx}')(head)
            if prev is not None:
                lateral = lateral + resize_spatial(
                    prev, lateral.shape[-2], lateral.shape[-1],
                    align_corners=True, channels_last=False)
            prev = lateral
            outputs.append(getattr(self, f'output_{idx}')(lateral))
        return outputs[::-1]


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """NCHW [B, A*width, H, W] -> [B, H*W*A, width] in NHWC row order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class ClassificationSubNet(nn.Module):
    """Per-level HeadBlock (squeeze-excite optional) + 3x3 output conv
    (focal bias init) + sigmoid."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 num_depth: int = 4, num_features: int = 256,
                 num_priors: int = 9, groups: int = 16,
                 dtype=torch.float32, use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_classes = num_classes
        self.num_blocks = len(in_channels)
        for idx, ch in enumerate(in_channels):
            self.add_module(f'block_{idx}', HeadBlock(
                ch, num_depth, num_features, groups, dtype,
                use_squeeze_excite, squeeze_ratio))
            self.add_module(f'output_{idx}', same_conv(
                num_features if num_depth else ch,
                num_priors * num_classes, 3, dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_blocks:
            raise ValueError(f'{len(inputs)} feature levels != '
                             f'num_blocks={self.num_blocks}')
        heads = []
        for idx, head in enumerate(inputs):
            x = getattr(self, f'block_{idx}')(head)
            x = torch.sigmoid(getattr(self, f'output_{idx}')(x))
            heads.append(_rows(x, self.num_classes))
        return torch.cat(heads, dim=1)


class BoxRegressionSubNet(nn.Module):
    """Per-level HeadBlock + 3x3 output conv of 4 deltas per prior."""

    def __init__(self, in_channels: Sequence[int], num_depth: int = 4,
                 num_features: int = 256, num_priors: int = 9,
                 groups: int = 16, dtype=torch.float32,
                 use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_blocks = len(in_channels)
        for idx, ch in enumerate(in_channels):
            self.add_module(f'block_{idx}', HeadBlock(
                ch, num_depth, num_features, groups, dtype,
                use_squeeze_excite, squeeze_ratio))
            self.add_module(f'output_{idx}', same_conv(
                num_features if num_depth else ch, num_priors * 4, 3,
                dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_blocks:
            raise ValueError(f'{len(inputs)} feature levels != '
                             f'num_blocks={self.num_blocks}')
        heads = []
        for idx, head in enumerate(inputs):
            x = getattr(self, f'block_{idx}')(head)
            heads.append(_rows(getattr(self, f'output_{idx}')(x), 4))
        return torch.cat(heads, dim=1)
