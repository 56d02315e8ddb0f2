"""Prior (anchor) box generation (the port's own copy of
``masklab_tpu/prior.py``, pure numpy).

Re-design of the reference's ``PriorBoxes`` table (engine/prior.py:9-71) and
``PriorLayer`` runtime grid (engine/layers/detection.py:236-306) as pure numpy
/ JAX functions with static shapes.

Semantics preserved exactly:
  * anchor (w, h) = round(size * scale * sqrt(ratio)), round(size * scale /
    sqrt(ratio)) using numpy banker's rounding (engine/prior.py:60-61);
  * levels are ordered by ascending stride (pandas ``groupby('stride')``
    sorts keys — engine/layers/detection.py:260-262);
  * grid centers at ``range(stride // 2, target, stride)`` where target is
    ``ceil(dim / stride) * stride`` for 'same' padding backbones and
    ``floor(...)`` for 'valid' (mobilenet) — detection.py:276-284;
  * output anchor order is row-major over (y, x, anchor) per level, levels
    concatenated — matching the head reshape order so cls/loc predictions
    align 1:1 with priors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class PriorBoxes:
    """Anchor-shape table: one (stride, w, h) row per (level, scale, ratio)."""

    def __init__(self, strides: Sequence[int], sizes: Sequence[int],
                 pr_scales: Sequence[float], pr_ratios: Sequence[float]):
        self.strides = [int(s) for s in np.asarray(strides).tolist()]
        self.sizes = [int(s) for s in np.asarray(sizes).tolist()]
        self.pr_scales = list(np.asarray(pr_scales, dtype=np.float64).tolist())
        self.pr_ratios = list(np.asarray(pr_ratios, dtype=np.float64).tolist())
        if len(self.strides) != len(self.sizes):
            raise ValueError('strides and sizes must have the same length')
        self.setup()
        self.config = {
            'strides': self.strides,
            'sizes': self.sizes,
            'pr_scales': self.pr_scales,
            'pr_ratios': self.pr_ratios,
        }

    def __len__(self) -> int:
        """Number of anchor shapes per grid point."""
        return len(self.pr_scales) * len(self.pr_ratios)

    def setup(self) -> None:
        """Build the (num_levels, A, 3) int table of (stride, w, h)."""
        rows = []
        for size, stride in zip(self.sizes, self.strides):
            level = []
            for scale in self.pr_scales:
                for ratio in self.pr_ratios:
                    w = int(np.round(size * scale * np.sqrt(ratio)))
                    h = int(np.round(size * scale / np.sqrt(ratio)))
                    level.append((stride, w, h))
            rows.append(level)
        table = np.asarray(rows, dtype=np.int64)  # [L, A, 3]
        # order levels by ascending stride (reference groupby-sort semantics)
        order = np.argsort(table[:, 0, 0], kind='stable')
        self.table = table[order]

    def get_config(self):
        return self.config


def level_grid_shape(height: int, width: int, stride: int,
                     padding: str = 'same') -> Tuple[int, int]:
    """Grid size of one pyramid level for a given static image size."""
    if padding == 'same':
        th = int(np.ceil(height / stride) * stride)
        tw = int(np.ceil(width / stride) * stride)
    else:  # 'valid' — mobilenet-style floor rounding
        th = int(np.floor(height / stride) * stride)
        tw = int(np.floor(width / stride) * stride)
    gy = len(range(stride // 2, th, stride))
    gx = len(range(stride // 2, tw, stride))
    return gy, gx


def generate_priors(height: int, width: int, prior: PriorBoxes,
                    padding: str = 'same') -> np.ndarray:
    """Build the full anchor grid for a static image size.

    Returns a float32 array ``[N, 4]`` of (cx, cy, w, h) in pixel units,
    where N = sum over levels of (gy * gx * A). Pure numpy: the model
    builds it once per input size and keeps it on the device.
    """
    out = []
    for level in prior.table:
        stride = int(level[0, 0])
        if padding == 'same':
            th = int(np.ceil(height / stride) * stride)
            tw = int(np.ceil(width / stride) * stride)
        else:
            th = int(np.floor(height / stride) * stride)
            tw = int(np.floor(width / stride) * stride)
        ys = np.arange(stride // 2, th, stride, dtype=np.float32)
        xs = np.arange(stride // 2, tw, stride, dtype=np.float32)
        xg, yg = np.meshgrid(xs, ys)                       # [gy, gx]
        gy, gx = yg.shape
        a = level.shape[0]
        boxes = np.empty((gy, gx, a, 4), dtype=np.float32)
        boxes[..., 0] = xg[..., None]
        boxes[..., 1] = yg[..., None]
        boxes[..., 2] = level[None, None, :, 1].astype(np.float32)
        boxes[..., 3] = level[None, None, :, 2].astype(np.float32)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out, axis=0)


def priors_from_config(configuration) -> PriorBoxes:
    """Derive the PriorBoxes table from a ModelConfiguration.

    Strides come from the backbone output names (``C3`` -> 8 ... ``P7`` ->
    128) and sizes are ``4 * stride`` (reference engine/retinamasklab.py:46-48).
    """
    strides = [2 ** int(name[-1])
               for name in configuration.backbone.backbone_outputs]
    sizes = [4 * s for s in strides]
    return PriorBoxes(strides=strides, sizes=sizes,
                      pr_scales=configuration.detection.pr_scales,
                      pr_ratios=configuration.detection.pr_ratios)
