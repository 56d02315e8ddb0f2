"""Grayscale morphology for semantic postprocessing.

Port of ``masklab_tpu/ops/morphology.py``: erosion and dilation with an
all-zero kernel are windowed min and max with SAME padding (the padding never
wins: +inf for min, -inf for max).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """SAME-padded stride-1 windowed max over the H, W axes of NHWC ``x``."""
    lo = (kernel_size - 1) // 2
    hi = kernel_size - 1 - lo
    nchw = x.movedim(-1, -3)
    padded = F.pad(nchw, (lo, hi, lo, hi), value=float('-inf'))
    return F.max_pool2d(padded, kernel_size, stride=1).movedim(-3, -1)


def erode(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Windowed min over kernel_size x kernel_size, SAME padding."""
    return -_window_max(-x, kernel_size)


def dilate(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Windowed max over kernel_size x kernel_size, SAME padding."""
    return _window_max(x, kernel_size)


def semantic_smoothing(x: torch.Tensor, kernel_size: int,
                       weight: float = 1.0) -> torch.Tensor:
    """Erosion -> dilation denoise, then a confidence weight, on NHWC."""
    x = x.float()
    if kernel_size > 0:
        x = dilate(erode(x, kernel_size), kernel_size)
    return x * weight
