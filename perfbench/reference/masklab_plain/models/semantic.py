"""Semantic path: ASPP + DeepLab V3+ decoder, and the training target.

Port of ``masklab_tpu/models/semantic.py:23-90``: a 1x1 branch, one
atrous-separable branch per rate, an image-pooling branch resized back with
align_corners, a 1x1 projection; the decoder concatenates the upsampled
ASPP output with a 1x1 skip projection and ends in a 1x1 sigmoid output.
``assign_seg`` resizes the gt map to the prediction's size.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.layers import AtrousSeparableConv, GroupNorm, HeadBlock, conv2d
from ..ops.resize import resize_spatial


class ASPPNetwork(nn.Module):
    def __init__(self, in_ch: int, num_features: int = 256,
                 atrous_rate: Sequence[int] = (6, 12, 18), groups: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.atrous_rate = tuple(atrous_rate)
        self.aspp_1x1 = conv2d(in_ch, num_features, 1, bias=False,
                               dtype=dtype)
        self.GroupNorm_0 = GroupNorm(num_features, groups)
        for rate in self.atrous_rate:
            self.add_module(f'aspp_{rate}', AtrousSeparableConv(
                in_ch, num_features, dilation_rate=rate, groups=groups,
                dtype=dtype))
        self.aspp_pool = conv2d(in_ch, num_features, 1, bias=False,
                                dtype=dtype)
        self.concat_projection = conv2d(
            num_features * (len(self.atrous_rate) + 2), num_features, 1,
            bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(num_features, groups)

    def forward(self, x):
        branches = [torch.relu(self.GroupNorm_0(self.aspp_1x1(x)))]
        for rate in self.atrous_rate:
            branches.append(getattr(self, f'aspp_{rate}')(x))
        pool = torch.relu(self.aspp_pool(x.mean((-2, -1), keepdim=True)))
        branches.append(resize_spatial(pool, x.shape[-2], x.shape[-1],
                                       align_corners=True,
                                       channels_last=False))
        y = self.concat_projection(torch.cat(branches, dim=1))
        return torch.relu(self.GroupNorm_1(y))


class SegmentationSubNet(nn.Module):
    def __init__(self, dec_ch: int, skip_ch: int, num_classes: int = 3,
                 num_depth: int = 2, num_features: int = 256,
                 num_skip_features: int = 48, groups: int = 16,
                 dtype=torch.float32, use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.skip_projection = conv2d(skip_ch, num_skip_features, 1,
                                      bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(num_skip_features, groups)
        self.HeadBlock_0 = HeadBlock(dec_ch + num_skip_features, num_depth,
                                     num_features, groups, dtype,
                                     use_squeeze_excite, squeeze_ratio)
        self.seg_output = conv2d(
            num_features if num_depth else dec_ch + num_skip_features,
            num_classes, 1, dtype=dtype)

    def forward(self, dec_input, skip_input):
        skip = torch.relu(self.GroupNorm_0(self.skip_projection(skip_input)))
        up = resize_spatial(dec_input, skip.shape[-2], skip.shape[-1],
                            align_corners=True, channels_last=False)
        x = self.HeadBlock_0(torch.cat([up, skip], dim=1))
        return torch.sigmoid(self.seg_output(x))


def assign_seg(gt_seg: torch.Tensor, seg_pred: torch.Tensor) -> torch.Tensor:
    """Resize gt seg [B, H, W, C] to the prediction's [B, h, w, C]
    (align-corners bilinear) and round half to even."""
    return torch.round(resize_spatial(gt_seg.float(), seg_pred.shape[-3],
                                      seg_pred.shape[-2], align_corners=True,
                                      channels_last=True))
