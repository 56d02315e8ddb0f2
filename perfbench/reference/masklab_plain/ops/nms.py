"""Class-aware two-stage NMS with fixed output slots.

Port of ``masklab_tpu/ops/nms.py`` (``candidate_pool`` :136-302,
``_nms_impl`` :381-446, ``batched_class_aware_nms`` :460):

  1. per class, the top ``candidates_per_class`` anchors by score form the
     candidate pool. Above ``sort_below`` anchors the pool comes from the
     segment top-k (kernel K2) with the reference's exactness certificate,
     and falls back to the exact top-k when the certificate fails;
  2. greedy NMS per (image, class) pool (kernel K3);
  3. survivors of all classes are merged in score order and a second greedy
     pass (K3 again) with ``post_iou_threshold`` fills the fixed
     ``[max_outputs, 6]`` slots, -1-padded.

Every top-k here orders like ``lax.top_k`` (value descending, then index
ascending) through a stable descending sort; ``torch.topk`` leaves the tie
order unspecified. The reference's single-key composite sort and its
sharded pool are TPU forms of the same values and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .boxes import cxcywh_to_yxyx
from .plain_kernels import SEGMENT_ROWS, nms_keep_mask, segment_topk_rows

NEG = -1.0
SEGMENT_CAP = 16       # extracts kept per segment

pool_fallbacks = 0     # certificate failures that took the exact top-k


def exact_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: value descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def candidate_pool(scores: torch.Tensor, k: int, floor: float,
                   sort_below: int = 32768):
    """Top-k candidate pool, equal to ``exact_topk(scores, k)`` for NMS
    purposes: every element with score >= floor that the exact top-k holds,
    in the same order; slots past the valid candidates hold (-1, 0).

    scores: [..., N] float32, invalid entries pre-masked below ``floor``.
    Returns (values [..., k] float32, indices [..., k] int64).
    """
    n = scores.shape[-1]
    if n <= max(8 * k, sort_below):
        return exact_topk(scores, k)
    return _pool_body(scores, k, floor)


def _pool_body(scores: torch.Tensor, k: int, floor: float):
    """The segment pool (``masklab_tpu/ops/nms.py:220-302``)."""
    global pool_fallbacks
    *batch, n = scores.shape
    cap = SEGMENT_CAP
    s = -(-n // SEGMENT_ROWS)
    # strided segmentation: segment j holds elements {j, j+s, j+2s, ...} of
    # the row padded with -inf to SEGMENT_ROWS * s; K2 reads the scores where
    # they lie (on the main path the [B, C, N] transpose of cls_pred)
    vals3, idxs3 = segment_topk_rows(scores.float(), cap, SEGMENT_ROWS)
    cand_v = vals3.reshape(*batch, cap * s)
    cand_i = idxs3.reshape(*batch, cap * s).long()

    # lexicographic (value desc, index asc): order by index, then a stable
    # sort by value keeps the lower index first among equal values
    by_index = torch.argsort(cand_i, dim=-1)
    cand_v = torch.gather(cand_v, -1, by_index)
    cand_i = torch.gather(cand_i, -1, by_index)
    top_v, order = exact_topk(cand_v, k)
    top_i = torch.gather(cand_i, -1, order)

    # exactness certificate on (value, index) keys: an element can be missing
    # only if its segment truncated it, i.e. the segment's last extract has
    # a strictly larger key than the pool's k-th
    lv = vals3[..., cap - 1, :].reshape(*batch, s)
    li = idxs3[..., cap - 1, :].reshape(*batch, s).long()
    kv = top_v[..., k - 1:k]
    ki = top_i[..., k - 1:k]
    truncating = (lv >= floor) & ((lv > kv) | ((lv == kv) & (li < ki)))
    if bool(truncating.any()):
        pool_fallbacks += 1
        return exact_topk(scores, k)
    dead = top_v < floor
    return (torch.where(dead, torch.full_like(top_v, NEG), top_v),
            torch.where(dead, torch.zeros_like(top_i), top_i))


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, N, D], idx [B, ...] -> [B, ..., D]."""
    b, d = table.shape[0], table.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(table, 1, flat[..., None].expand(-1, -1, d))
    return out.reshape(*idx.shape, d)


def batched_class_aware_nms(cls_pred: torch.Tensor, boxes: torch.Tensor,
                            min_confidence: float = 0.05,
                            nms_iou_threshold: float = 0.4,
                            post_iou_threshold: float = 0.65,
                            max_outputs: int = 100,
                            candidates_per_class: int = 256,
                            sort_below: int = 32768) -> torch.Tensor:
    """Batched class-aware two-stage NMS.

    cls_pred [B, N, C] sigmoid confidences, boxes [B, N, 4] decoded
    (cx, cy, w, h) -> [B, max_outputs, 6] rows (cx, cy, w, h, class, conf)
    in descending confidence, -1-padded.
    """
    b, n, num_classes = cls_pred.shape
    kc = min(candidates_per_class, n)
    boxes = boxes.float()
    cls_pred = cls_pred.float()
    boxes_yxyx = cxcywh_to_yxyx(boxes)

    # stage 1: per-class candidate pools and greedy NMS in each
    scores_t = cls_pred.transpose(1, 2)                         # [B, C, N]
    masked = torch.where(scores_t >= min_confidence, scores_t,
                         torch.full_like(scores_t, NEG))
    top_scores, top_idx = candidate_pool(masked, kc, floor=min_confidence,
                                         sort_below=sort_below)
    top_boxes = _gather_rows(boxes_yxyx, top_idx)               # [B,C,kc,4]
    top_valid = top_scores >= min_confidence
    kept = nms_keep_mask(
        top_boxes.reshape(b * num_classes, kc, 4).contiguous(),
        top_valid.reshape(b * num_classes, kc).contiguous(),
        nms_iou_threshold, max_outputs).reshape(b, num_classes, kc)
    cand_scores = torch.where(kept, top_scores,
                              torch.full_like(top_scores, NEG))

    # stage 2: cross-class post-NMS over all survivors
    class_ids = torch.arange(num_classes, device=cls_pred.device)
    flat_scores = cand_scores.reshape(b, -1)                    # [B, C*kc]
    flat_idx = top_idx.reshape(b, -1)
    flat_class = class_ids[:, None].expand(num_classes, kc).reshape(-1)
    k2 = min(num_classes * kc, num_classes * max_outputs)
    s2_scores, order = exact_topk(flat_scores, k2)              # [B, k2]
    s2_anchor = torch.gather(flat_idx, 1, order)
    s2_class = flat_class[order]
    s2_boxes_yxyx = _gather_rows(boxes_yxyx, s2_anchor)
    s2_valid = s2_scores >= min_confidence
    kept2 = nms_keep_mask(s2_boxes_yxyx.contiguous(), s2_valid.contiguous(),
                          post_iou_threshold, max_outputs)

    # compact kept rows (already score-sorted) into the fixed output slots
    final_scores = torch.where(kept2, s2_scores,
                               torch.full_like(s2_scores, float('-inf')))
    out_scores, out_sel = exact_topk(final_scores, max_outputs)
    out_valid = torch.isfinite(out_scores)
    out_anchor = torch.gather(s2_anchor, 1, out_sel)
    out_boxes = _gather_rows(boxes, out_anchor)                 # [B, M, 4]
    out_class = torch.gather(s2_class, 1, out_sel).float()
    result = torch.cat([out_boxes, out_class[..., None],
                        out_scores[..., None]], dim=-1)
    return torch.where(out_valid[..., None], result,
                       torch.full_like(result, NEG))
