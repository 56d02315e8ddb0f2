"""Task losses as functions returning per-sample values.

Port of ``masklab_tpu/losses.py``: the focal class loss, the self-adjusting
smooth-L1 box loss with its moving statistics in an explicit
``BoxLossState``, the per-RoI mask BCE and the per-class semantic BCE. Mask
semantics (1 = negative, 0 = positive, -1 = ignore) follow
``split_neg_pos_mask``. EPS is Keras' epsilon, 1e-7.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


EPS = 1e-7


def focal_loss(y_true, y_pred, gamma=2.0, alpha=0.25):
    y_pred = torch.clamp(y_pred, EPS, 1.0 - EPS)
    pt = torch.where(y_true == 1.0, y_pred, 1.0 - y_pred)
    return -alpha * torch.pow(1.0 - pt, gamma) * torch.log(pt)


def smooth_l1(y_true, y_pred, beta=0.11):
    """Generalized smooth-L1, mean over the last (coordinate) axis, with the
    reference's branch condition ``where(l1 - 0.5*beta < beta, l2, l1 -
    0.5*beta)`` kept as it is."""
    diff = torch.abs(y_true - y_pred)
    l1 = diff - 0.5 * beta
    l2 = 0.5 * diff ** 2 / beta
    return torch.where(l1 < beta, l2, l1).mean(-1)


def binary_cross_entropy(y_true, y_pred, label_smoothing=0.0):
    y_true = (1.0 - label_smoothing) * y_true + label_smoothing / 2.0
    return -(y_true * torch.log(y_pred + EPS)
             + (1.0 - y_true) * torch.log(1.0 - y_pred + EPS))


def split_neg_pos_mask(mask):
    return (mask == 1.0).float(), (mask == 0.0).float(), (mask != -1.0).float()


def class_loss(cls_true, cls_pred, mask, cls_exists, weight=1.0, alpha=0.25,
               gamma=2.0):
    """Focal classification loss -> [B]. cls_true / cls_pred [B, N, C]; mask
    [B, N, 1]; cls_exists [B, C] gates each class's loss per image."""
    cls_exists = cls_exists.float()[:, None, :]
    neg, pos, ignore = split_neg_pos_mask(mask)
    y = (cls_true != 0.0).float()
    num_tot = (pos + neg).sum((1, 2))
    loss = focal_loss(y, cls_pred, gamma, alpha) * cls_exists
    return weight * ((ignore * loss).sum((1, 2)) / (num_tot + EPS))


class BoxLossState(NamedTuple):
    """Moving statistics of the self-adjusting smooth-L1 beta."""
    moving_mean: torch.Tensor   # [4], init beta
    moving_var: torch.Tensor    # [4], init 0

    @classmethod
    def create(cls, beta: float = 0.11, device=None):
        return cls(torch.full((4,), beta, dtype=torch.float32, device=device),
                   torch.zeros(4, dtype=torch.float32, device=device))

    def detach(self) -> 'BoxLossState':
        return BoxLossState(self.moving_mean.detach(),
                            self.moving_var.detach())


def box_loss(loc_true, loc_pred, mask, state: BoxLossState, weight=1.0,
             momentum=0.9, beta=0.11,
             use_adjust=True) -> Tuple[torch.Tensor, BoxLossState]:
    """Self-adjusting smooth-L1 -> ([B], next state). As in the reference,
    this step's *updated* moving mean / var set the clipped beta, and the
    gradient flows through them into ``loc_pred``; the caller detaches the
    returned state before the next step."""
    neg, pos, ignore = split_neg_pos_mask(mask)
    num_pos = pos.sum((1, 2))
    if use_adjust:
        offsets = torch.abs(loc_true - loc_pred) * pos
        mean = offsets.mean((0, 1))
        var = ((offsets - mean) ** 2).mean((0, 1))
        state = BoxLossState(state.moving_mean * momentum
                             + mean * (1 - momentum),
                             state.moving_var * momentum
                             + var * (1 - momentum))
        beta_t = torch.clamp(state.moving_mean - state.moving_var, 1e-3, beta)
    else:
        beta_t = beta
    loss = smooth_l1(loc_true, loc_pred, beta=beta_t)
    loss = (pos[..., 0] * loss).sum(1) / (num_pos + EPS)
    return weight * loss, state


def mask_loss(mask_true, mask_pred, weight=1.0, label_smoothing=0.0):
    """Per-RoI BCE on the gt-class mask channel -> [B]. mask_true [B, R, h,
    w] int in [0, C] (C: background or unmatched), mask_pred [B, R, h, w, C]
    sigmoids. Invalid RoIs contribute 0; the normalizer counts the nonzero
    per-RoI losses, plus 1."""
    num_classes = mask_pred.shape[-1]
    mask_true = mask_true.to(torch.int64)
    roi_class = mask_true.amin((2, 3))                            # [B, R]
    valid = (roi_class < num_classes).float()
    ch = torch.clamp(roi_class, 0, num_classes - 1)
    idx = ch[:, :, None, None, None].expand(*mask_pred.shape[:-1], 1)
    pred = torch.gather(mask_pred, -1, idx)[..., 0]               # [B, R, h, w]
    true = (mask_true == ch[:, :, None, None]).float()
    per_roi = binary_cross_entropy(true, pred, label_smoothing).mean(
        (2, 3)) * valid
    count = (per_roi != 0).float().sum(1)
    return weight * (per_roi.sum(1) / (count + 1.0))


def seg_loss(seg_true, seg_pred, seg_exists, weight=1.0, label_smoothing=0.0):
    """Per-class BCE gated by the seg-exists flags -> [B]."""
    loss = binary_cross_entropy(seg_true, seg_pred, label_smoothing)
    loss = loss.mean((1, 2)) \
        * seg_exists.float()                                       # [B, C]
    return weight * loss.mean(1)
