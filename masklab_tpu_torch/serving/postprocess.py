"""Inference postprocessing: smoothing, upsample, full-frame mask paste.

Port of ``masklab_tpu/serving/postprocess.py:31-135``:

  * per-channel semantic smoothing with the configured kernels/weights;
  * ``upsample_output``: boxes rescaled per axis to the original resolution
    and cast to int, confidence x100, masks binarized, semantics
    align-corners-resized and thresholded;
  * ``crop_and_pad_masks``: each RoI mask resized into its box and pasted
    into the full frame, as two per-box interpolation matrices; when the
    best confidence of an image is above 50 only boxes >= 50 are pasted;
  * ``paste_stats_and_union`` (``:138-200``): the reductions of that paste
    which the analytics and the instance overlay read, in one pass.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..ops.cuda.paste_stats import paste, paste_reduce, paste_weights
from ..ops.morphology import semantic_smoothing
from ..ops.resize import resize_bilinear
from .visualize import class_one_hot


def smooth_semantics(seg_pred: torch.Tensor, kernel_sizes: Sequence[int],
                     weights: Sequence[float]) -> torch.Tensor:
    """Per-channel erosion/dilation smoothing of NHWC ``seg_pred``."""
    chans = [semantic_smoothing(seg_pred[..., i:i + 1], int(k), float(w))
             for i, (k, w) in enumerate(zip(kernel_sizes, weights))]
    return torch.cat(chans, dim=-1)


def upsample_output(roi_boxes: torch.Tensor, roi_masks: torch.Tensor,
                    semantic: torch.Tensor, src_hw: Tuple[int, int],
                    dst_hw: Tuple[int, int]):
    """Restore outputs to the original resolution (UpSampleOutput)."""
    ry = dst_hw[0] / src_hw[0]
    rx = dst_hw[1] / src_hw[1]
    cx, cy, w, h, label, conf = roi_boxes.unbind(-1)
    boxes = torch.stack([cx * rx, cy * ry, w * rx, h * ry, label,
                         conf * 100], dim=-1).to(torch.int32)
    masks = (roi_masks > 0.5).to(torch.int32)
    semantic = resize_bilinear(semantic, dst_hw[0], dst_hw[1],
                               align_corners=True)
    return boxes, masks, (semantic > 0.5).to(torch.int32)


def _paste_edges(det_boxes: torch.Tensor, image_hw: Tuple[int, int],
                 conf_threshold: float):
    """Box -> clipped (y1, y2, x1, x2) and the per-image adaptive keep flag
    (boxes floored at 1; if an image's best confidence is above the
    threshold only boxes at or above it are kept)."""
    h, w = image_hw
    boxes = torch.clamp(det_boxes.float(), min=1.0)
    conf = det_boxes[..., -1].float()
    best = conf.max(-1, keepdim=True).values
    thr = torch.where(best > conf_threshold,
                      torch.full_like(best, conf_threshold),
                      torch.full_like(best, -100.0))
    keep = conf >= thr
    cx, cy, bw, bh = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    x1 = torch.clamp(cx - bw / 2, 0, w)
    x2 = torch.clamp(cx + bw / 2, 0, w)
    y1 = torch.clamp(cy - bh / 2, 0, h)
    y2 = torch.clamp(cy + bh / 2, 0, h)
    return y1, y2, x1, x2, keep.float()


def crop_and_pad_masks(det_boxes: torch.Tensor, roi_masks: torch.Tensor,
                       image_hw: Tuple[int, int],
                       conf_threshold: float = 50.0) -> torch.Tensor:
    """Paste RoI masks into full-frame coordinates -> [B, K, H, W] float32.

    det_boxes [B, K, 6] in upsampled units (conf x100), roi_masks
    [B, K, mh, mw].
    """
    y1, y2, x1, x2, keep = _paste_edges(det_boxes, image_hw, conf_threshold)
    return paste(y1, y2, x1, x2, keep, roi_masks, image_hw)


def paste_stats_and_union(det_boxes: torch.Tensor, roi_masks: torch.Tensor,
                          image_hw: Tuple[int, int], unit: torch.Tensor,
                          my_road: torch.Tensor, num_classes: int,
                          conf_threshold: float = 50.0,
                          with_union: bool = True) -> Dict:
    """The statistics of the full-frame mask paste the analytics and the
    instance overlay read, without handing the pasted [B, K, H, W] tensor
    to more than one consumer.

    The paste is separable (full = wy @ mask @ wx^T), so the linear
    statistics (pixel count, size, horizontal extent) contract through the
    small [K, mh] / [K, mw] axes; the thresholded ones (vertical extent,
    my_road overlap, area, class union) come from
    ``ops.cuda.paste_reduce``: on the card one kernel over each kept box's
    own pixels, on the CPU one pass over the pasted tensor.

    det_boxes [B, K, 6] upsampled rows (conf x100); roi_masks [B, K, mh, mw]
    (0/1); unit [B, H] metres per pixel of each row; my_road [B, H, W] bool
    -> dict of pixel / size / horiz / vert / inter / area [B, K] and union
    [B, H, W, num_classes] float 0/1 (None unless ``with_union``), the
    values of reducing ``crop_and_pad_masks``' output."""
    h, w = image_hw
    mh, mw = roi_masks.shape[-2], roi_masks.shape[-1]
    y1, y2, x1, x2, keep = _paste_edges(det_boxes, image_hw, conf_threshold)
    wy = paste_weights(y1, y2, h, mh)                         # [B, K, H, mh]
    wx = paste_weights(x1, x2, w, mw)                         # [B, K, W, mw]
    m = roi_masks.float()
    # linear statistics through the mask axes
    sy = wy.sum(2)                                            # [B, K, mh]
    sx = wx.sum(2)                                            # [B, K, mw]
    u1y = torch.einsum('by,bkym->bkm', unit, wy)
    u2y = torch.einsum('by,bkym->bkm', unit * unit, wy)
    msx = torch.einsum('bkmn,bkn->bkm', m, sx)
    pixel = keep * torch.einsum('bkm,bkm->bk', sy, msx)
    size = keep * torch.einsum('bkm,bkm->bk', u2y, msx)
    rowvec = torch.einsum('bkm,bkmn->bkn', u1y, m)            # [B, K, mw]
    colw = torch.einsum('bkxn,bkn->bkx', wx, rowvec)          # [B, K, W]
    horiz = keep * colw.max(-1).values
    # thresholded statistics
    onehot = (class_one_hot(det_boxes[..., 4].to(torch.int64), num_classes)
              * keep[..., None]) if with_union else None
    area, inter, rowany, union = paste_reduce(y1, y2, x1, x2, keep, m,
                                              my_road, onehot)
    vert = (unit[:, None, :] * rowany).sum(-1)
    return dict(pixel=pixel, size=size, horiz=horiz, vert=vert, inter=inter,
                area=area, union=union)
