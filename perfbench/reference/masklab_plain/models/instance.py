"""Instance-mask branch: level routing, per-level mask heads, trim.

Port of ``masklab_tpu/models/instance.py`` (``mask_distribute`` :36-47,
``_PixelShuffleUp`` :69-98, ``_LevelMaskHead`` :101-132,
``MaskSubNet.compact`` :194-293, ``assign_masks`` :310-342,
``trim_instances`` :345-360).

The reference's capacity ladder (static bucket sizes under ``lax.switch``)
and its one-hot scatter matmul are TPU forms. Here each level's head runs
on exactly the boxes routed to it and the masks are written back by index;
the values equal the reference's ``select_by_level`` of every level's
masks.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import HeadBlock, conv2d
from ..ops.boxes import cxcywh_to_yxyx, pairwise_iou
from ..ops.roi_align import batched_crop_and_resize, crop_and_resize_indexed

EPS = 1e-7


def mask_distribute(boxes: torch.Tensor, max_k: int = 2,
                    base_size: float = 36.0) -> torch.Tensor:
    """Route each box to a pyramid level: floor(log2(sqrt(w*h) / base))
    clipped to [0, max_k]; padded rows (cx == -1) get level -1."""
    w, h = boxes[..., 2], boxes[..., 3]
    size = torch.sqrt(torch.clamp(w * h, min=0.0))
    delta_k = torch.log((size + EPS) / (base_size + EPS)) / torch.log(
        torch.tensor(2.0, dtype=size.dtype, device=size.device))
    k = torch.clamp(torch.floor(delta_k), 0, max_k)
    return torch.where(boxes[..., 0] == -1.0, torch.full_like(k, -1.0),
                       k).to(torch.int64)


class PixelShuffleUp(nn.ConvTranspose2d):
    """2x2 / stride-2 transposed conv (the reference's ``_PixelShuffleUp``):
    out[2i+dy, 2j+dx] = x[i, j] . kernel[1-dy, 1-dx] + bias, where kernel is
    the flax [2, 2, C_in, F] array; the bridge stores it flipped as this
    module's [C_in, F, 2, 2] weight. float32 parameters, computed in
    ``dtype``."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__(in_ch, features, 2, stride=2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2)


class LevelMaskHead(nn.Module):
    """One pyramid level's head: [N, C, h, w] -> [N, classes, 2h, 2w]."""

    def __init__(self, in_ch: int, num_classes: int, num_depth: int,
                 num_features: int, groups: int, dtype=torch.float32,
                 use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.block = HeadBlock(in_ch, num_depth, num_features, groups, dtype,
                               use_squeeze_excite, squeeze_ratio)
        feats = num_features if num_depth else in_ch
        self.upsample = PixelShuffleUp(feats, num_features, dtype)
        self.output = conv2d(num_features, num_classes, 1, dtype=dtype)

    def forward(self, x):
        y = torch.relu(self.upsample(self.block(x)))
        return torch.sigmoid(self.output(y))


class MaskSubNet(nn.Module):
    """Per-level mask heads (``level_0`` .. ``level_{max_k}``). A head's
    squeeze-excite pools each RoI crop alone, as the reference's heads on
    [N, h, w, C] crops do."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 num_depth: int = 4, num_features: int = 256,
                 groups: int = 16, dtype=torch.float32,
                 use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_classes = num_classes
        for i, ch in enumerate(in_channels):
            self.add_module(f'level_{i}', LevelMaskHead(
                ch, num_classes, num_depth, num_features, groups, dtype,
                use_squeeze_excite, squeeze_ratio))
        self.num_levels = len(in_channels)

    def forward(self, features: Sequence[torch.Tensor], boxes: torch.Tensor,
                levels: torch.Tensor, image_hw: Tuple[int, int],
                crop_size: Tuple[int, int]) -> torch.Tensor:
        """features: NCHW maps of levels 0..max_k, one per head; boxes
        [B, K, >=4] (cx, cy, w, h); levels [B, K] -> masks
        [B, K, 2ch, 2cw, classes] float32, zeros for boxes of level -1."""
        if len(features) != self.num_levels:
            raise ValueError(f'{len(features)} feature levels != '
                             f'{self.num_levels} mask heads')
        return routed_heads(
            features, boxes, levels, image_hw, crop_size, self.num_classes,
            lambda idx, x: getattr(self, f'level_{idx}')(x))


def routed_heads(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                 levels: torch.Tensor, image_hw: Tuple[int, int],
                 crop_size: Tuple[int, int], num_classes: int,
                 head) -> torch.Tensor:
    """Crop each box from its own level and run that level's head on it:
    ``head(idx, crops)`` maps level idx's crops [n, C, ch, cw]
    (channels_last) to [n, classes, 2ch, 2cw]. Masks [B, K, 2ch, 2cw,
    classes] float32, written back by index, zeros for boxes of level -1.
    Reads the levels on the host once."""
    b, k = levels.shape
    ch, cw = crop_size
    norm = cxcywh_to_yxyx(boxes[..., :4].float(), image_hw)
    out = torch.zeros((b, k, 2 * ch, 2 * cw, num_classes),
                      dtype=torch.float32, device=boxes.device)
    levels_host = levels.cpu()
    for idx, fmap in enumerate(features):
        is_l = levels_host == idx                                 # [B, K]
        counts = is_l.sum(1)
        cap = int(counts.max())
        if cap == 0:
            continue
        # this level's boxes first per image, in their original order
        order = torch.argsort((~is_l).to(torch.int8), dim=1,
                              stable=True)[:, :cap]               # [B, cap]
        live = torch.arange(cap)[None, :] < counts[:, None]       # [B, cap]
        img = torch.arange(b)[:, None].expand(b, cap)[live]
        slot = order[live]
        sel = order.to(boxes.device)
        sel_boxes = torch.gather(norm, 1, sel[..., None].expand(-1, -1, 4))
        crops = batched_crop_and_resize(fmap.permute(0, 2, 3, 1), sel_boxes,
                                        crop_size)
        crops = crops[live.to(boxes.device)]                      # [n, ch, cw, C]
        head_in = crops.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        y = head(idx, head_in)                                    # [n, cls, 2ch, 2cw]
        out[img.to(boxes.device), slot.to(boxes.device)] = (
            y.permute(0, 2, 3, 1).float())
    return out


def assign_masks(roi_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_masks: torch.Tensor, mask_hw: Tuple[int, int],
                 num_classes: int,
                 match_iou_threshold: float = 0.5) -> torch.Tensor:
    """Class-id-valued mask targets -> [B, R, mh, mw] int32.

    roi_boxes [B, R, 6], gt_boxes [B, G, 6], gt_masks [B, G, H, W] (0/1, -1
    padding). Each RoI matches the same-class valid gt of highest IoU (the
    first on ties); its target is that gt's mask cropped to the RoI, the gt's
    class where the crop > 0.5 and ``num_classes`` elsewhere, or everywhere
    when the best IoU is below ``match_iou_threshold``.
    """
    image_hw = (gt_masks.shape[2], gt_masks.shape[3])
    out = []
    for rois, gts, masks in zip(roi_boxes.float(), gt_boxes.float(),
                                gt_masks):
        iou = pairwise_iou(gts[:, :4], rois[:, :4])               # [G, R]
        valid = ((gts[:, None, 5] != -1.0)
                 & (rois[None, :, 5] != -1.0)).float()
        same_class = (gts[:, None, 4] == rois[None, :, 4]).float()
        iou = iou * valid * same_class
        matched = iou.amax(0) >= match_iou_threshold             # [R]
        gt_idx = iou.argmax(0)                                     # [R]
        norm = cxcywh_to_yxyx(rois[:, :4], image_hw)
        crops = crop_and_resize_indexed(masks[..., None].float(), norm,
                                        gt_idx, mask_hw)[..., 0]
        cls = torch.where(matched, gts[gt_idx, 4], float(num_classes))
        out.append(torch.where(crops > 0.5, cls[:, None, None],
                               float(num_classes)).to(torch.int32))
    return torch.stack(out)


def trim_instances(roi_boxes: torch.Tensor, roi_masks: torch.Tensor):
    """Select each box's predicted-class mask channel: boxes [B, R, 6],
    masks [B, R, h, w, C] -> (boxes, masks [B, R, h, w]), -1 for padding."""
    num_classes = roi_masks.shape[-1]
    cls = roi_boxes[..., 4]
    valid = cls != -1.0
    ch = torch.clamp(cls.to(torch.int64), 0, num_classes - 1)
    idx = ch[:, :, None, None, None].expand(*roi_masks.shape[:-1], 1)
    masks = torch.gather(roi_masks, -1, idx)[..., 0]
    masks = torch.where(valid[:, :, None, None], masks,
                        torch.full_like(masks, -1.0))
    return roi_boxes, masks
