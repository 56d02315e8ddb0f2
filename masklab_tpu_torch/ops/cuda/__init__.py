"""Hand-written CUDA kernels for Hopper, one wrapper module per kernel
(the counterpart of ``masklab_tpu/ops/pallas/``).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, counting the launches.
"""
from __future__ import annotations

from . import batch_norm_act, groupnorm, nms_keep, paste_stats, topk
from .groupnorm import (BandGroupNormFn, band_groupnorm,
                        band_groupnorm_backward, band_groupnorm_backward_plain,
                        band_groupnorm_plain)
from .nms_keep import nms_keep_mask, nms_keep_mask_plain
from .paste_stats import paste_reduce, paste_reduce_plain
from .topk import (segment_topk, segment_topk_plain, segment_topk_rows,
                   segment_topk_rows_plain)

# wrapper name -> (module, its launch counter)
_COUNTERS = {'band_groupnorm': (groupnorm, 'launches'),
             'band_groupnorm_backward': (groupnorm, 'backward_launches'),
             'segment_topk': (topk, 'launches'),
             'nms_keep': (nms_keep, 'launches'),
             'paste_stats': (paste_stats, 'launches'),
             'batch_norm_act': (batch_norm_act, 'launches')}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


__all__ = ['band_groupnorm', 'band_groupnorm_plain', 'BandGroupNormFn',
           'band_groupnorm_backward', 'band_groupnorm_backward_plain',
           'segment_topk',
           'segment_topk_plain', 'segment_topk_rows', 'segment_topk_rows_plain',
           'nms_keep_mask', 'nms_keep_mask_plain',
           'paste_reduce', 'paste_reduce_plain',
           'launch_counts', 'reset_launch_counts']
