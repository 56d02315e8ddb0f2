"""RoI crop-and-resize on the ``tf.image.crop_and_resize`` grid.

Port of ``masklab_tpu/ops/roi_align.py:21-98``: sample i of a box spanning
normalized [lo, hi] sits at ``(lo + (hi - lo) * i / (crop - 1)) * (size - 1)``
and samples outside [0, size - 1] read 0 (TF's extrapolation value). The
bilinear sampling is applied as two per-box interpolation matrices, as in
the reference; torchvision's ``roi_align`` samples on another grid.
"""
from __future__ import annotations

import torch


def _sample_weights(lo: torch.Tensor, hi: torch.Tensor, crop: int,
                    size: int) -> torch.Tensor:
    """Interpolation matrices [..., crop, size] for box edges ``lo``/``hi``
    of shape [...] (normalized), zeroed where a sample leaves the map."""
    scale = float(size - 1)
    if crop > 1:
        steps = torch.arange(crop, dtype=torch.float32,
                             device=lo.device) / (crop - 1)
        pos = (lo[..., None] + (hi - lo)[..., None] * steps) * scale
    else:
        pos = (0.5 * (lo + hi))[..., None] * scale
    inside = (pos >= 0.0) & (pos <= scale)
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - grid), min=0.0)
    return w * inside[..., None]


def _own_rows(wy: torch.Tensor, rows) -> torch.Tensor:
    return wy if rows is None else wy[..., rows[1]:rows[2]]


def batched_crop_and_resize(fmaps: torch.Tensor, boxes_yxyx: torch.Tensor,
                            crop_size=(14, 14), rows=None) -> torch.Tensor:
    """[B, H, W, C] maps x [B, K, 4] normalized boxes -> [B, K, ch, cw, C].

    A bfloat16 map is interpolated in bfloat16 (f32 accumulation), like the
    reference's bf16 branch; a float64 map in float64; otherwise everything
    runs in float32.
    ``rows`` = (the map's rows, start, stop): ``fmaps`` holds rows [start,
    stop) of it, and the result is their share of the crops (the crops are
    its sum over the blocks).
    """
    h = fmaps.shape[1] if rows is None else rows[0]
    w = fmaps.shape[2]
    ch, cw = crop_size
    boxes_yxyx = boxes_yxyx.float()
    wy = _own_rows(_sample_weights(boxes_yxyx[..., 0], boxes_yxyx[..., 2],
                                   ch, h), rows)
    wx = _sample_weights(boxes_yxyx[..., 1], boxes_yxyx[..., 3], cw, w)
    if fmaps.dtype in (torch.bfloat16, torch.float64):
        wy, wx = wy.to(fmaps.dtype), wx.to(fmaps.dtype)
    else:
        fmaps = fmaps.float()
    rows = torch.einsum('bkih,bhwc->bkiwc', wy, fmaps)
    return torch.einsum('bkjw,bkiwc->bkijc', wx, rows)


def crop_and_resize_indexed(fmaps: torch.Tensor, boxes_yxyx: torch.Tensor,
                            box_indices: torch.Tensor,
                            crop_size=(14, 14), rows=None) -> torch.Tensor:
    """``tf.image.crop_and_resize`` with a source image per box, in float32:
    [N, H, W, C] maps x [K, 4] normalized boxes x [K] indices ->
    [K, ch, cw, C]. ``rows``: as ``batched_crop_and_resize``."""
    h = fmaps.shape[1] if rows is None else rows[0]
    w = fmaps.shape[2]
    ch, cw = crop_size
    boxes_yxyx = boxes_yxyx.float()
    wy = _own_rows(_sample_weights(boxes_yxyx[:, 0], boxes_yxyx[:, 2], ch,
                                   h), rows)
    wx = _sample_weights(boxes_yxyx[:, 1], boxes_yxyx[:, 3], cw, w)
    rows = torch.einsum('kih,khwc->kiwc', wy, fmaps[box_indices].float())
    return torch.einsum('kjw,kiwc->kijc', wx, rows)


def crop_and_resize(fmap: torch.Tensor, boxes_yxyx: torch.Tensor,
                    crop_size=(14, 14)) -> torch.Tensor:
    """One image: [H, W, C] x [K, 4] -> [K, ch, cw, C]."""
    return batched_crop_and_resize(fmap[None], boxes_yxyx[None],
                                   crop_size)[0]
