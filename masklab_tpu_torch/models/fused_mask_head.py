"""Fused mask head: one head whose parameters are stacked over the levels.

Port of ``masklab_tpu/models/fused_mask_head.py`` (``FusedMaskSubNet``
:58-111, ``select_crops_by_level`` :114-122). Each box runs with its own
level's weights; the parameters keep the reference's stacked flax layout
(``conv{d}_kernel`` [L, 3, 3, Cin, F], ``conv{d}_bias``, ``gn{d}_scale``,
``gn{d}_bias`` [L, F], ``deconv_kernel`` [L, 2, 2, F, F], ``deconv_bias``
[L, F], ``output_kernel`` [L, F, classes], ``output_bias`` [L, classes]),
float32, so the weight bridge maps them by name.

The reference gathers every box's weights and runs per-box batched GEMMs, a
TPU form. Here the boxes are grouped by level on the host and each level
runs stock convolutions with its own slice of the stacked weights: the
values are the reference's, without a [N, 3, 3, C, F] gathered kernel. A box
of level -1 gets zeros (the reference runs it with level 0's weights and
then zeroes its output; its per-box GroupNorm touches no other box).

Unlike the per-level heads (``instance.MaskSubNet``, whose GroupNorm is the
flat-band K1), the GroupNorm here is textbook per box: float32 statistics
over (h, w, C/G), eps 1e-5, the normalized value cast back to the
activation dtype before the float32 affine. The reference's dtype promotion
is kept: that affine promotes the activations to float32, so in bf16 only
the first conv runs in bf16; every later product runs in float32 with
weights rounded to bf16 first.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .instance import routed_heads


def select_crops_by_level(per_level_crops: Sequence[torch.Tensor],
                          levels: torch.Tensor) -> torch.Tensor:
    """Pick each box's crop from its routed level: per_level_crops, one
    [B, K, h, w, C] a level; levels [B, K] -> [B, K, h, w, C], zeros for
    level -1 (the reference's one-hot product, as an index)."""
    stacked = torch.stack(list(per_level_crops))              # [L, B, K, ...]
    b, k = levels.shape
    rows = torch.arange(b, device=levels.device)[:, None].expand(b, k)
    cols = torch.arange(k, device=levels.device)[None, :].expand(b, k)
    own = stacked[levels.clamp(min=0), rows, cols]
    valid = (levels >= 0).reshape(b, k, *(1,) * (own.dim() - 2))
    return torch.where(valid, own, torch.zeros_like(own))


def _per_box_groupnorm(x: torch.Tensor, groups: int, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Textbook GroupNorm of each box of x [n, C, h, w] with float32
    statistics; the normalized value in x's dtype, then the float32 affine
    (whose product promotes a bf16 x to float32, as in the reference)."""
    n, c, h, w = x.shape
    xg = x.float().reshape(n, min(groups, c), -1)
    var, mean = torch.var_mean(xg, dim=2, correction=0, keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    return xn.to(x.dtype) * scale[:, None, None] + bias[:, None, None]


class FusedMaskSubNet(nn.Module):
    """Mask head with level-stacked parameters: crops [n, Cin, h, w] of one
    level -> [n, classes, 2h, 2w] (``head``); ``forward`` takes the feature
    maps, boxes and levels, as ``MaskSubNet`` does. ``dtype`` is the
    compute dtype; the parameters stay float32 (the predictor does not cast
    them)."""

    def __init__(self, num_levels: int, in_ch: int, num_classes: int,
                 num_depth: int = 4, num_features: int = 256,
                 groups: int = 16, dtype=torch.float32):
        super().__init__()
        self.num_levels, self.num_classes = num_levels, num_classes
        self.num_depth, self.groups, self.dtype = num_depth, groups, dtype
        lv, f = num_levels, num_features

        def param(name, *shape):
            self.register_parameter(name, nn.Parameter(torch.zeros(
                lv, *shape)))
        cin = in_ch
        for d in range(num_depth):
            param(f'conv{d}_kernel', 3, 3, cin, f)
            param(f'conv{d}_bias', f)
            param(f'gn{d}_scale', f)
            param(f'gn{d}_bias', f)
            cin = f
        param('deconv_kernel', 2, 2, cin, f)
        param('deconv_bias', f)
        param('output_kernel', f, num_classes)
        param('output_bias', num_classes)

    def _weight(self, name: str, level: int, x: torch.Tensor):
        """Level ``level``'s ``name`` rounded to the compute dtype, and the
        dtype its product with x runs in (JAX's promotion)."""
        w = getattr(self, name)[level].to(self.dtype)
        dt = torch.promote_types(x.dtype, w.dtype)
        return w.to(dt), dt

    def head(self, level: int, x: torch.Tensor) -> torch.Tensor:
        """Crops of level ``level``, [n, Cin, h, w] -> float32 masks
        [n, classes, 2h, 2w]."""
        x = x.to(self.dtype)
        for d in range(self.num_depth):
            k, dt = self._weight(f'conv{d}_kernel', level, x)
            x = F.conv2d(x.to(dt), k.permute(3, 2, 0, 1), padding=1)
            x = torch.relu(x + getattr(self, f'conv{d}_bias')[level].to(
                self.dtype)[:, None, None])
            x = _per_box_groupnorm(x, self.groups,
                                   getattr(self, f'gn{d}_scale')[level],
                                   getattr(self, f'gn{d}_bias')[level])
        # 2x2 stride-2 transposed conv, out[2i+a, 2j+b] = x[i, j] . k[a, b]
        # (the reference's einsum: no spatial flip)
        k, dt = self._weight('deconv_kernel', level, x)
        up = F.conv_transpose2d(x.to(dt), k.permute(2, 3, 0, 1), stride=2)
        up = torch.relu(up + self.deconv_bias[level][:, None, None])
        k, dt = self._weight('output_kernel', level, up)
        out = F.conv2d(up.to(dt), k.t()[:, :, None, None])
        return torch.sigmoid(out + self.output_bias[level][:, None, None]
                             ).float()

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                levels: torch.Tensor, image_hw: Tuple[int, int],
                crop_size: Tuple[int, int]) -> torch.Tensor:
        """The reference's fused mask branch (every level cropped, each box
        taking its own level's crop, the head run on it): features NCHW of
        levels 0..L-1, boxes [B, K, >=4], levels [B, K] -> masks
        [B, K, 2ch, 2cw, classes]. Each box is cropped from its own level
        only, which gives the selected crops without the others."""
        if len(features) != self.num_levels:
            raise ValueError(f'{len(features)} feature levels != '
                             f'{self.num_levels} levels of the fused head')
        return routed_heads(features, boxes, levels, image_hw, crop_size,
                            self.num_classes, self.head)
