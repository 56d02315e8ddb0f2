"""Hand-written CUDA kernels for Hopper, one wrapper module per kernel
(the counterpart of ``masklab_tpu/ops/pallas/``).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, counting the launches.
"""
from __future__ import annotations

from . import groupnorm, nms_keep, topk
from .groupnorm import band_groupnorm, band_groupnorm_plain
from .nms_keep import nms_keep_mask, nms_keep_mask_plain
from .topk import (segment_topk, segment_topk_plain, segment_topk_rows,
                   segment_topk_rows_plain)

_WRAPPERS = {'band_groupnorm': groupnorm, 'segment_topk': topk,
             'nms_keep': nms_keep}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


__all__ = ['band_groupnorm', 'band_groupnorm_plain', 'segment_topk',
           'segment_topk_plain', 'segment_topk_rows', 'segment_topk_rows_plain',
           'nms_keep_mask', 'nms_keep_mask_plain',
           'launch_counts', 'reset_launch_counts']
