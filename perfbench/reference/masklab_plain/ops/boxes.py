"""Box coordinate ops: encode / decode, corner conversion, pairwise IoU.

Port of ``masklab_tpu/ops/boxes.py:18-105``. All boxes are (cx, cy, w, h)
in pixel units unless stated otherwise; every function computes in float32
with the reference's operation order, so identical inputs round alike.
"""
from __future__ import annotations

import torch


def decode_boxes(loc_pred: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """SSD-style decode: deltas + priors -> (cx, cy, w, h).

    loc_pred [..., N, 4], priors [N, 4] or [..., N, 4].
    """
    loc_pred = loc_pred.float()
    priors = priors.float()
    cx = loc_pred[..., 0] * priors[..., 2] + priors[..., 0]
    cy = loc_pred[..., 1] * priors[..., 3] + priors[..., 1]
    w = torch.exp(loc_pred[..., 2]) * priors[..., 2]
    h = torch.exp(loc_pred[..., 3]) * priors[..., 3]
    return torch.stack([cx, cy, w, h], dim=-1)


def encode_boxes(gt_boxes: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`decode_boxes`: the anchor targets (dcx, dcy, dw,
    dh) of (cx, cy, w, h) boxes against priors."""
    gt = gt_boxes.float()
    pr = priors.float()
    dcx = (gt[..., 0] - pr[..., 0]) / pr[..., 2]
    dcy = (gt[..., 1] - pr[..., 1]) / pr[..., 3]
    dw = torch.log(gt[..., 2] / pr[..., 2])
    dh = torch.log(gt[..., 3] / pr[..., 3])
    return torch.stack([dcx, dcy, dw, dh], dim=-1)


def cxcywh_to_yxyx(boxes: torch.Tensor, image_hw=None) -> torch.Tensor:
    """(cx, cy, w, h) -> (y1, x1, y2, x2), optionally divided by image size."""
    boxes = boxes.float()
    cx, cy, w, h = boxes.unbind(-1)
    ih, iw = (1.0, 1.0) if image_hw is None else (float(image_hw[0]),
                                                 float(image_hw[1]))
    x1 = (cx - w / 2.0) / iw
    y1 = (cy - h / 2.0) / ih
    x2 = (cx + w / 2.0) / iw
    y2 = (cy + h / 2.0) / ih
    return torch.stack([y1, x1, y2, x2], dim=-1)


def pairwise_iou(a_boxes: torch.Tensor, b_boxes: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., Na, Nb] of two (cx, cy, w, h) box sets with the
    reference's ``union + 1e-5`` denominator (``CalculateIOU``)."""
    a = a_boxes.float()
    b = b_boxes.float()
    areas = ((a[..., :, 2] * a[..., :, 3])[..., :, None]
             + (b[..., :, 2] * b[..., :, 3])[..., None, :])
    ay1, ax1, ay2, ax2 = cxcywh_to_yxyx(a)[..., :, None, :].unbind(-1)
    by1, bx1, by2, bx2 = cxcywh_to_yxyx(b)[..., None, :, :].unbind(-1)
    in_h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       min=0.0)
    in_w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       min=0.0)
    intersection = in_h * in_w
    return intersection / (areas - intersection + 1e-5)


def iou_yxyx(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., Na, Nb] for corner-format boxes, exact union (no
    epsilon), in the operation order of the reference so NMS keep decisions
    match it bit for bit."""
    a = a.float()
    b = b.float()
    a_area = (a[..., :, 2] - a[..., :, 0]) * (a[..., :, 3] - a[..., :, 1])
    b_area = (b[..., :, 2] - b[..., :, 0]) * (b[..., :, 3] - b[..., :, 1])
    ay1, ax1, ay2, ax2 = a[..., :, None, :].unbind(-1)
    by1, bx1, by2, bx2 = b[..., None, :, :].unbind(-1)
    in_h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       min=0.0)
    in_w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       min=0.0)
    inter = in_h * in_w
    union = (a_area[..., :, None] + b_area[..., None, :]) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
