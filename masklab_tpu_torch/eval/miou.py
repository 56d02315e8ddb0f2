"""Evaluation harness: per-class mask mIoU + semantic mIoU.

The port's own copy of ``masklab_tpu/eval/miou.py``, on the port's
``MaskLabPredictor`` (raw mode): per validation image run inference, paste
RoI masks to full frame, match predictions to gt at box-IoU 0.5, accumulate
per-class instance mask IoU and per-channel semantic IoU (crack IoU only
counted when instances exist).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..data.dataset import MaskLabDataset
from ..serving.predictor import MaskLabPredictor


def _box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between (cx, cy, w, h) box sets."""
    def corners(x):
        return np.stack([x[:, 0] - x[:, 2] / 2, x[:, 1] - x[:, 3] / 2,
                         x[:, 0] + x[:, 2] / 2, x[:, 1] + x[:, 3] / 2], -1)
    ac, bc = corners(a.astype(np.float64)), corners(b.astype(np.float64))
    iw = np.maximum(0, np.minimum(ac[:, None, 2], bc[None, :, 2])
                    - np.maximum(ac[:, None, 0], bc[None, :, 0]))
    ih = np.maximum(0, np.minimum(ac[:, None, 3], bc[None, :, 3])
                    - np.maximum(ac[:, None, 1], bc[None, :, 1]))
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / (union + 1e-9)


def evaluate_dataset(predictor: MaskLabPredictor, dataset: MaskLabDataset,
                     instance_labels: Sequence[str],
                     semantic_labels: Sequence[str],
                     max_images: int = None) -> Dict[str, float]:
    """Run the mask-mIoU / semantic-mIoU loop over a dataset."""
    inst_ious: Dict[str, List[float]] = {l: [] for l in instance_labels}
    sem_ious: Dict[str, List[float]] = {l: [] for l in semantic_labels}

    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)
    for i in range(n):
        sample = dataset[i]
        out = predictor.predict(sample['images'])
        det = out['det_boxes'][0]                  # [K, 6] int
        padded = out['padded_masks'][0]            # [K, H, W]
        semantic = out['semantic'][0]              # [H, W, S]

        gt_boxes = sample['detection']             # [G, 6]
        gt_masks = sample['instance']              # [G, H, W]
        valid_pred = det[:, 2] > 0
        valid_gt = gt_boxes[:, 0] != -1 if len(gt_boxes) else \
            np.zeros((0,), bool)

        # instance matching: EVERY class-consistent (gt, pred) pair with
        # box IoU > 0.5 contributes a mask-IoU sample — the reference's
        # zip(*np.where(iou > 0.5)) accumulation (train.py:182-191), not
        # a per-gt best match (duplicate detections contribute multiple
        # samples there, and the historical numbers depend on it). The
        # union == 0 guard is a deliberate deviation: the reference
        # divides by np.sum(mask_union) bare, so an empty-vs-empty pair
        # poisons its running sum with nan.
        if valid_gt.any() and valid_pred.any():
            pb = det[valid_pred][:, :4].astype(np.float64)
            gb = gt_boxes[valid_gt][:, :4]
            iou = _box_iou_matrix(gb, pb)
            pcls = det[valid_pred][:, 4]
            gcls = gt_boxes[valid_gt][:, 4]
            iou = iou * (gcls[:, None] == pcls[None, :])
            pmasks = padded[valid_pred]
            gmasks = gt_masks[valid_gt]
            for gi, pi in zip(*np.where(iou > 0.5)):
                gm = gmasks[gi] > 0
                pm = pmasks[pi] > 0.5
                union = (gm | pm).sum()
                if union == 0:
                    continue
                mask_iou = (gm & pm).sum() / union
                inst_ious[instance_labels[int(gcls[gi])]].append(mask_iou)

        # semantic IoU per channel; crack only when instances exist.
        # Deliberate deviation: the reference scores other_road/my_road on
        # EVERY image (train.py:195-205) — an image without the label
        # counts as IoU 0 even when the prediction is also empty (a
        # correct rejection). Gating on semantic_exist scores only images
        # where the label is annotated.
        for si, label in enumerate(semantic_labels):
            if not sample['semantic_exist'][si]:
                continue
            if label == 'crack' and not valid_gt.any():
                continue
            gm = sample['semantic'][..., si] > 0
            pm = semantic[..., si] > 0
            union = (gm | pm).sum()
            if union == 0:
                continue
            sem_ious[label].append((gm & pm).sum() / union)

    metrics: Dict[str, float] = {}
    for label, vals in inst_ious.items():
        metrics[f'mask_iou/{label}'] = float(np.mean(vals)) if vals else 0.0
    for label, vals in sem_ious.items():
        metrics[f'semantic_iou/{label}'] = (float(np.mean(vals))
                                            if vals else 0.0)
    inst_vals = [v for vals in inst_ious.values() for v in vals]
    sem_vals = [v for vals in sem_ious.values() for v in vals]
    metrics['mask_miou'] = float(np.mean(inst_vals)) if inst_vals else 0.0
    metrics['semantic_miou'] = float(np.mean(sem_vals)) if sem_vals else 0.0
    return metrics
