"""Detection path: FPN, the classification / box-regression heads, and the
training targets of each anchor.

Port of ``masklab_tpu/models/detection.py:30-186``. Heads take the NCHW
feature list in ascending-stride order and return rows in the reference's
[B, sum(H*W*A), C] order (row-major over y, x, anchor; levels concatenated),
so row i lines up with prior i.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..nn.layers import HeadBlock, conv2d, same_conv
from ..ops.resize import resize_spatial
from ..ops.boxes import encode_boxes, pairwise_iou


class FeaturePyramid(nn.Module):
    """Top-down FPN: 1x1 lateral + align-corners upsample-add, then a 3x3
    output conv per level (no norm, no activation)."""

    def __init__(self, in_channels: Sequence[int], num_features: int = 256,
                 dtype=torch.float32):
        super().__init__()
        for idx, ch in enumerate(reversed(list(in_channels))):
            self.add_module(f'lateral_{idx}',
                            conv2d(ch, num_features, 1, dtype=dtype))
            self.add_module(f'output_{idx}',
                            same_conv(num_features, num_features, 3,
                                      dtype=dtype))
        self.num_levels = len(in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outputs, prev = [], None
        for idx, head in enumerate(inputs[::-1]):
            lateral = getattr(self, f'lateral_{idx}')(head)
            if prev is not None:
                lateral = lateral + resize_spatial(
                    prev, lateral.shape[-2], lateral.shape[-1],
                    align_corners=True, channels_last=False)
            prev = lateral
            outputs.append(getattr(self, f'output_{idx}')(lateral))
        return outputs[::-1]


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """NCHW [B, A*width, H, W] -> [B, H*W*A, width] in NHWC row order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class ClassificationSubNet(nn.Module):
    """Per-level HeadBlock (squeeze-excite optional) +
    3x3 output conv (focal bias init) + sigmoid."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 num_depth: int = 4, num_features: int = 256,
                 num_priors: int = 9, groups: int = 16,
                 dtype=torch.float32, use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_classes = num_classes
        self.num_blocks = len(in_channels)
        for idx, ch in enumerate(in_channels):
            self.add_module(f'block_{idx}', HeadBlock(
                ch, num_depth, num_features, groups, dtype,
                use_squeeze_excite, squeeze_ratio))
            self.add_module(f'output_{idx}', same_conv(
                num_features if num_depth else ch,
                num_priors * num_classes, 3, dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_blocks:
            raise ValueError(f'{len(inputs)} feature levels != '
                             f'num_blocks={self.num_blocks}')
        heads = []
        for idx, head in enumerate(inputs):
            x = getattr(self, f'block_{idx}')(head)
            x = torch.sigmoid(getattr(self, f'output_{idx}')(x))
            heads.append(_rows(x, self.num_classes))
        return torch.cat(heads, dim=1)


class BoxRegressionSubNet(nn.Module):
    """Per-level HeadBlock + 3x3 output conv of 4 deltas per prior."""

    def __init__(self, in_channels: Sequence[int], num_depth: int = 4,
                 num_features: int = 256, num_priors: int = 9,
                 groups: int = 16, dtype=torch.float32,
                 use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_blocks = len(in_channels)
        for idx, ch in enumerate(in_channels):
            self.add_module(f'block_{idx}', HeadBlock(
                ch, num_depth, num_features, groups, dtype,
                use_squeeze_excite, squeeze_ratio))
            self.add_module(f'output_{idx}', same_conv(
                num_features if num_depth else ch, num_priors * 4, 3,
                dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_blocks:
            raise ValueError(f'{len(inputs)} feature levels != '
                             f'num_blocks={self.num_blocks}')
        heads = []
        for idx, head in enumerate(inputs):
            x = getattr(self, f'block_{idx}')(head)
            heads.append(_rows(getattr(self, f'output_{idx}')(x), 4))
        return torch.cat(heads, dim=1)


def batched_assign_boxes(gt_boxes: torch.Tensor, priors: torch.Tensor,
                         num_classes: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    """Anchor targets of a batch (the reference's ``assign_boxes`` over each
    image, ``masklab_tpu/models/detection.py:118-186``).

    gt_boxes [B, G, 6] (cx, cy, w, h, class, conf), -1-padded rows; priors
    [N, 4]. Returns cls_true [B, N, C] one-hot, loc_true [B, N, 4] encoded
    deltas and assign_mask [B, N, 1] (1 negative, 0 positive, -1 ignore).
    An anchor takes its highest-IoU gt (the first on ties) at IoU >= 0.5; each
    gt with conf > 0 also claims its best anchor (the first on ties), the
    highest gt index winning an anchor claimed twice; IoU in [0.4, 0.5) with
    any gt overrides to ignore. The reference's one-hot row select is a TPU
    form of the gather used here.
    """
    gt = gt_boxes.float()
    b, g = gt.shape[:2]
    n = priors.shape[0]
    valid_gt = (gt[..., 0] != -1.0).float()                       # [B, G]
    iou = pairwise_iou(gt[..., :4], priors) * valid_gt[..., None]  # [B, G, N]
    best_gt = iou.argmax(1)          # [B, N]; the first index on ties
    anchor_matched = iou.amax(1) >= 0.5
    best_anchor = iou.argmax(2)                                    # [B, G]
    gt_ids = torch.arange(g, device=gt.device).expand(b, g)
    claims = torch.where(gt[..., 5] > 0.0, gt_ids, -1)
    forced = torch.full((b, n), -1, dtype=torch.int64, device=gt.device)
    forced = forced.scatter_reduce(1, best_anchor, claims, 'amax')
    chosen = torch.where(forced >= 0, forced, best_gt)
    assigned = anchor_matched | (forced >= 0)
    rows = torch.gather(gt, 1, chosen[..., None].expand(b, n, 6))  # [B, N, 6]
    cls_idx = torch.where(assigned, rows[..., 4].to(torch.int64), num_classes)
    cls_full = torch.nn.functional.one_hot(cls_idx, num_classes + 1).float()
    in_band = ((iou < 0.5) & (iou >= 0.4)).any(1)
    assign_mask = torch.where(in_band, -1.0, cls_full[..., num_classes])
    loc_true = encode_boxes(rows[..., :4], priors)
    loc_true = torch.where(assigned[..., None], loc_true, 0.0)
    loc_true = torch.nan_to_num(loc_true, nan=0.0, posinf=0.0, neginf=0.0)
    return cls_full[..., :num_classes], loc_true, assign_mask[..., None]
