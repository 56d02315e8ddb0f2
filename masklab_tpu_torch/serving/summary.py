"""Road-geometry analytics: the summary table of the serving outputs.

Port of ``masklab_tpu/serving/summary.py:30-204``; the JAX package's
``vmap`` over images becomes batched tensor code:

  * ``crack_to_instance``: the crack semantic channel as one synthetic
    instance row per image (bbox of its nonzero pixels, class 5,
    confidence 100 when the bbox has area, else 0);
  * ``include_my_road``: instance-within-my_road overlap above 10%;
  * ``calculate_instance_size``: metres per pixel for each image row from a
    least-squares fit of the my_road edges against the lane width, then
    each instance's real-world area and horizontal / vertical extents;
  * ``summary_output`` / ``fused_summary_union``: the per-instance rows
    [class, cx, cy, w, h, conf, pixel_count, est_size, horiz_len,
    vert_len, include_my_road] plus the crack row, the fused form reducing
    the mask paste without keeping it (``postprocess.paste_stats_and_union``).

The edge fit is the reference's closed-form 2x2 normal equations in
float32. Its sums over the image rows are not exact above ~200 rows, so a
summation order other than XLA's moves the fitted line by more than an ulp
(tests/test_torch_serving.py states the deviation measured).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .postprocess import paste_stats_and_union

EPS = 1e-5
_BIG = 1e9


def crack_to_instance(crack: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """crack [B, H, W] (0/1) -> (det rows [B, 1, 6], masks [B, 1, H, W])."""
    _, h, w = crack.shape
    ys = torch.arange(h, dtype=torch.float32, device=crack.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=crack.device)[None, :]
    on = crack > 0
    big = torch.tensor(_BIG, dtype=torch.float32, device=crack.device)

    def extreme(grid, fill, reduce):
        return reduce(torch.where(on, grid, fill).flatten(1), dim=1).values

    ymin = extreme(ys, big, torch.min)
    ymax = extreme(ys, -big, torch.max)
    xmin = extreme(xs, big, torch.min)
    xmax = extreme(xs, -big, torch.max)
    any_on = on.flatten(1).any(1)
    zero = torch.zeros_like(ymin)
    ymin, ymax, xmin, xmax = (torch.where(any_on, v, zero)
                              for v in (ymin, ymax, xmin, xmax))
    height = (ymax - ymin).to(torch.int32)
    width = (xmax - xmin).to(torch.int32)
    cy = ymin.to(torch.int32) + height // 2
    cx = xmin.to(torch.int32) + width // 2
    class_id = torch.full_like(cx, 5)
    # 100 when the bbox has area: a predicate on the int32 product, as the
    # reference computes it, not a clip of 100 * h * w (which overflows)
    conf = torch.where(height * width > 0, torch.full_like(cx, 100),
                       torch.zeros_like(cx))
    det = torch.stack([cx, cy, width, height, class_id, conf],
                      dim=-1)[:, None, :].float()
    return det, crack[:, None].float()


def include_my_road(seg: torch.Tensor, padded_masks: torch.Tensor,
                    threshold: float = 0.1) -> torch.Tensor:
    """Instance-overlaps-my-road flag -> [B, K] float 0/1."""
    my_road = seg[..., 1].float() > 0.5                       # [B, H, W]
    inst = padded_masks.float() > 0.5                         # [B, K, H, W]
    inter = (my_road[:, None] & inst).float().sum((2, 3))
    area = inst.float().sum((2, 3))
    return (inter / (area + EPS) > threshold).float()


def road_width_per_row(my_road: torch.Tensor,
                       default_road_size: float) -> torch.Tensor:
    """Metres per pixel of each image row from the my_road edge fit:
    my_road [B, H, W] -> [B, H]."""
    _, h, w = my_road.shape
    dev = my_road.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    on = my_road > 0
    x_min = torch.where(on, xs, torch.full_like(xs, _BIG)).min(-1).values
    x_max = torch.where(on, xs, torch.full_like(xs, -_BIG)).max(-1).values
    valid = on.any(-1) & (x_min != x_max)                      # [B, H]

    # drop the first and last 15% of the valid rows (noise trim)
    order = torch.cumsum(valid.to(torch.int32), -1, dtype=torch.int32)
    total = order[:, -1:]
    drop = torch.clamp((total.float() * 0.15).to(torch.int32), 1,
                       2 ** 31 - 1)
    keep = valid & (order > drop) & (order <= total - drop)

    ys = torch.arange(h, dtype=torch.float32, device=dev)
    kf = keep.float()
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def fit(targets):
        # least squares x = a * y + b over the kept rows, closed form
        n = kf.sum(-1)
        sy = (kf * ys).sum(-1)
        syy = (kf * ys * ys).sum(-1)
        st = (kf * targets).sum(-1)
        syt = (kf * ys * targets).sum(-1)
        det = syy * n - sy * sy
        a = torch.where(det > 0, (n * syt - sy * st) / (det + EPS), zero)
        b = torch.where(det > 0, (syy * st - sy * syt) / (det + EPS), zero)
        return a[:, None], b[:, None]

    la, lb = fit(torch.where(keep, x_min, zero))
    ra, rb = fit(torch.where(keep, x_max, zero))
    width_by_row = torch.clamp((ys * ra + rb) - (ys * la + lb), min=1.0)
    return default_road_size / width_by_row


def calculate_instance_size(seg: torch.Tensor, padded_masks: torch.Tensor,
                            default_road_size: float = 3.25) -> torch.Tensor:
    """Per-instance (est_size, horizontal, vertical) -> [B, K, 3]."""
    unit = road_width_per_row(seg[..., 1].float(), default_road_size)
    masks = padded_masks.float()
    instance_size = ((unit ** 2)[:, None, :, None] * masks).sum((2, 3))
    vertical = (unit[:, None, :] * (masks > 0.5).any(-1).float()).sum(-1)
    horizontal = (unit[:, None, :, None] * masks).sum(2).max(-1).values
    return torch.stack([instance_size, horizontal, vertical], dim=-1)


def _crack_rows(seg: torch.Tensor, default_road_size: float) -> torch.Tensor:
    """The synthetic crack row of each image -> [B, 1, 11]."""
    det, mask = crack_to_instance(seg[..., 2])
    sizes = calculate_instance_size(seg, mask, default_road_size)
    return torch.stack([
        det[..., 4], det[..., 0], det[..., 1], det[..., 2], det[..., 3],
        det[..., 5], mask.sum((2, 3)), sizes[..., 0], sizes[..., 1],
        sizes[..., 2], include_my_road(seg, mask)], dim=-1)


def fused_summary_union(det_boxes: torch.Tensor, seg: torch.Tensor,
                        roi_masks: torch.Tensor, image_hw: Tuple[int, int],
                        num_classes: int, default_road_size: float = 3.25,
                        conf_threshold: float = 50.0,
                        with_union: bool = True):
    """The analytics table and the per-class instance union, reduced from
    the mask paste in one pass (``paste_stats_and_union``).

    det_boxes [B, K, 6] upsampled rows; seg [B, H, W, C_seg] binarized
    semantics (my_road at 1, crack at 2); roi_masks [B, K, mh, mw]
    binarized -> (summary [B, K + 1, 11], union [B, H, W, num_classes]
    float 0/1, or None unless ``with_union``: the table does not read it)."""
    my_road = seg[..., 1].float()
    unit = road_width_per_row(my_road, default_road_size)     # [B, H]
    stats = paste_stats_and_union(det_boxes, roi_masks, image_hw, unit,
                                  my_road > 0.5, num_classes, conf_threshold,
                                  with_union)
    inst = det_boxes.float()
    inc = (stats['inter'] / (stats['area'] + EPS) > 0.1).float()
    inst_rows = torch.stack([
        inst[..., 4], inst[..., 0], inst[..., 1], inst[..., 2], inst[..., 3],
        inst[..., 5], stats['pixel'], stats['size'], stats['horiz'],
        stats['vert'], inc], dim=-1)                          # [B, K, 11]
    return (torch.cat([inst_rows, _crack_rows(seg, default_road_size)], 1),
            stats['union'])


def summary_output(det_boxes: torch.Tensor, seg: torch.Tensor,
                   padded_masks: torch.Tensor,
                   default_road_size: float = 3.25) -> torch.Tensor:
    """Analytics table from full-frame masks -> [B, K + 1, 11]; the last
    row is the crack, confidence 0 when there is none."""
    crack_det, crack_mask = crack_to_instance(seg[..., 2])
    det = torch.cat([det_boxes.float(), crack_det], 1)
    masks = torch.cat([padded_masks.float(), crack_mask], 1)
    cx, cy, w, h, classes, conf = det.unbind(-1)
    sizes = calculate_instance_size(seg, masks, default_road_size)
    return torch.stack([classes, cx, cy, w, h, conf, masks.sum((2, 3)),
                        sizes[..., 0], sizes[..., 1], sizes[..., 2],
                        include_my_road(seg, masks)], dim=-1)
