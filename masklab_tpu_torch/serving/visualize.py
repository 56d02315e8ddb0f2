"""Drawing: segmentation / instance overlays and box borders.

Port of ``masklab_tpu/serving/visualize.py:17-67``:

  * ``draw_segmentation``: per-class alpha-blended colour overlay;
  * ``draw_instance``: per-class union of pasted instance masks, then
    blended;
  * ``draw_boxes``: 1-px white box borders computed from coordinate grids.

Every uint8 result is the truncation of a float32 value clipped to
[0, 255], computed in the reference's order (``images + color_map *
alpha``), so the port's pixels equal the JAX package's.
"""
from __future__ import annotations

from typing import Sequence

import torch


def draw_segmentation(images: torch.Tensor, seg: torch.Tensor,
                      colors: Sequence[Sequence[int]],
                      alpha: float = 0.3) -> torch.Tensor:
    """images [B, H, W, 3] x seg [B, H, W, C] (0/1) -> uint8 overlay."""
    images = images.float()
    colors = torch.tensor(colors, dtype=torch.float32, device=images.device)
    color_map = torch.einsum('bhwc,cd->bhwd', seg.float(), colors)
    vis = torch.clamp(images + color_map * alpha, 0, 255)
    return vis.to(torch.uint8)


def class_one_hot(cls: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot``: float rows, all zero for ids outside
    [0, num_classes) (the -1 of padded slots)."""
    grid = torch.arange(num_classes, device=cls.device)
    return (cls[..., None] == grid).float()


def draw_instance(images: torch.Tensor, det_boxes: torch.Tensor,
                  padded_masks: torch.Tensor,
                  colors: Sequence[Sequence[int]],
                  alpha: float = 0.3) -> torch.Tensor:
    """Union per class of full-frame masks, then blend. det_boxes [B, K, 6]
    (class at 4, -1 padding); padded_masks [B, K, H, W]."""
    onehot = class_one_hot(det_boxes[..., 4].to(torch.int64), len(colors))
    stacked = torch.einsum('bkhw,bkc->bhwc', (padded_masks > 0.5).float(),
                           onehot)
    return draw_segmentation(images, (stacked > 0.5).float(), colors, alpha)


def draw_boxes(images: torch.Tensor, det_boxes: torch.Tensor) -> torch.Tensor:
    """1-px white borders for each box of positive width."""
    h, w = images.shape[1], images.shape[2]
    boxes = torch.clamp(det_boxes[..., :4].float(), min=0.0)
    cx, cy, bw, bh = boxes.unbind(-1)
    x1, x2 = cx - bw / 2, cx + bw / 2
    y1, y2 = cy - bh / 2, cy + bh / 2
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    xs = torch.arange(w, dtype=torch.float32, device=images.device)
    in_y = (ys >= y1[..., None]) & (ys <= y2[..., None])         # [B, K, H]
    in_x = (xs >= x1[..., None]) & (xs <= x2[..., None])         # [B, K, W]
    on_y_edge = ((ys - y1[..., None]).abs() < 1.0) | \
                ((ys - y2[..., None]).abs() < 1.0)
    on_x_edge = ((xs - x1[..., None]).abs() < 1.0) | \
                ((xs - x2[..., None]).abs() < 1.0)
    valid = (det_boxes[..., 2] > 0)[..., None, None]             # [B, K, 1, 1]
    border = ((on_y_edge[..., :, None] & in_x[..., None, :])
              | (in_y[..., :, None] & on_x_edge[..., None, :])) & valid
    border = border.any(1)                                       # [B, H, W]
    vis = torch.where(border[..., None], torch.full_like(images, 255,
                                                         dtype=torch.float32),
                      images.float())
    return torch.clamp(vis, 0, 255).to(torch.uint8)
