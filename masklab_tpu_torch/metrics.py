"""Train-time metrics.

Port of ``masklab_tpu/metrics.py``: per-class binary IoU of the semantic
map, detection precision / recall / F1 at IoU 0.5, and the anchor
confusion-matrix metric (defined, unused, in the reference).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .nn import spatial
from .ops.boxes import pairwise_iou

EPS = 1e-7


def confusion_matrix_metric(cls_true, cls_pred, mask, threshold=0.3):
    """Anchor-classification precision, recall, accuracy and F1.
    cls_true / cls_pred [B, N, C]; mask [B, N, 1] (1 neg, 0 pos, -1
    ignore)."""
    num_classes = cls_pred.shape[-1]
    ct = cls_true.reshape(-1, num_classes)
    cp = cls_pred.reshape(-1, num_classes)
    m = mask.reshape(-1)
    ignore = (m != -1.0).float()
    y_true = torch.where(m == 0.0, ct.argmax(1), num_classes)
    y_pred = torch.where(cp.amax(1) > threshold, cp.argmax(1), num_classes)
    correct = y_true == y_pred
    predicted_pos = y_pred < num_classes
    tp = ((correct & predicted_pos) * ignore).sum()
    fp = ((~correct & predicted_pos) * ignore).sum()
    fn = ((~correct & ~predicted_pos) * ignore).sum()
    tn = ((correct & ~predicted_pos) * ignore).sum()
    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    accuracy = (tp + tn) / (tp + tn + fp + fn + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)
    return precision, recall, accuracy, f1


def class_binary_iou(seg_true, seg_pred, threshold=0.5):
    """Per-class binary IoU -> [B, C] (1.0 where the union is empty); the
    pixel counts over the frame's rows when sharded (``nn.spatial``)."""
    t = (seg_true > threshold).float()
    p = (seg_pred > threshold).float()
    inter, t_sum, p_sum = spatial.sum_hw(torch.stack([t * p, t, p]), (2, 3))
    union = t_sum + p_sum - inter
    return torch.where(union > 0, inter / union, torch.ones_like(union))


def detection_iou_metric(proposed_boxes, gt_boxes
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision / recall / F1 at IoU 0.5 -> three [B] tensors.
    proposed_boxes [B, K, 6] and gt_boxes [B, G, 6], -1-padded."""
    prop, gt = proposed_boxes.float(), gt_boxes.float()
    prop_valid = (prop[..., 0] != -1.0).float()
    gt_valid = (gt[..., 0] != -1.0).float()
    iou = pairwise_iou(prop[..., :4], gt[..., :4])
    iou = iou * prop_valid[..., :, None] * gt_valid[..., None, :]
    num_pos = (iou.amax(2) > 0.5).float().sum(1)
    num_true = (iou.amax(1) > 0.5).float().sum(1)
    precision = num_pos / (prop_valid.sum(1) + EPS)
    recall = num_true / (gt_valid.sum(1) + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)
    return precision, recall, f1
