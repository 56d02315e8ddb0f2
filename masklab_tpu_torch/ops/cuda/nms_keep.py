"""K3: greedy NMS keep-mask, and its plain version.

Kernel: ``masklab_tpu_torch/csrc/nms_keep.cu``, in place of the Pallas
``nms_keep_mask_pallas`` / ``batched_nms_keep_mask_pallas``
(``masklab_tpu/ops/pallas/nms_kernel.py``) and the XLA fixpoint
``nms_keep_mask`` they equal. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel.
"""
from __future__ import annotations

import torch

from ..boxes import iou_yxyx
from ._build import check, library

launches = 0   # kernel launches since the last reset
MAX_K = 64 * 32
MAX_SMEM = 227 * 1024
_smem_bytes = {}       # (R, K) -> shared memory one CTA of the launch needs
_ready_devices = set()  # devices whose kernel may use MAX_SMEM


def nms_keep_mask_plain(boxes_yxyx: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float,
                        max_outputs: int) -> torch.Tensor:
    """Sequential greedy NMS (``masklab_tpu/ops/nms.py:305-327``) over R
    score-sorted sets: boxes [R, K, 4], valid [R, K] -> keep [R, K] bool.
    An earlier kept box suppresses a later one when IoU > t (strict); at
    most ``max_outputs`` boxes are kept per set."""
    r, k, _ = boxes_yxyx.shape
    iou = iou_yxyx(boxes_yxyx, boxes_yxyx)                      # [R, K, K]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes_yxyx.device).triu(1)
    suppress_from = (iou > iou_threshold) & later
    suppressed = torch.zeros(r, k, dtype=torch.bool, device=valid.device)
    kept = torch.zeros(r, k, dtype=torch.bool, device=valid.device)
    count = torch.zeros(r, dtype=torch.int64, device=valid.device)
    for i in range(k):
        can_keep = valid[:, i] & ~suppressed[:, i] & (count < max_outputs)
        kept[:, i] = can_keep
        suppressed |= can_keep[:, None] & suppress_from[:, i]
        count += can_keep
    return kept


def _smem(lib, r: int, k: int) -> int:
    key = (r, k)
    if key not in _smem_bytes:
        _smem_bytes[key] = lib.mlk_nms_keep_smem_bytes(r, k)
    return _smem_bytes[key]


def nms_keep_mask(boxes_yxyx: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float, max_outputs: int) -> torch.Tensor:
    """Greedy NMS keep-mask over R score-sorted sets of K boxes: float32
    [R, K, 4] (y1, x1, y2, x2) and bool [R, K] -> bool [R, K]. CPU tensors
    take :func:`nms_keep_mask_plain`."""
    global launches
    if boxes_yxyx.device.type == 'cpu':
        return nms_keep_mask_plain(boxes_yxyx, valid, iou_threshold,
                                   max_outputs)
    if boxes_yxyx.device.type != 'cuda':
        raise ValueError(f'nms_keep_mask: unsupported device '
                         f'{boxes_yxyx.device}')
    if (boxes_yxyx.dim() != 3 or boxes_yxyx.shape[-1] != 4
            or boxes_yxyx.dtype != torch.float32
            or not boxes_yxyx.is_contiguous()):
        raise ValueError('nms_keep_mask: boxes must be a contiguous float32 '
                         f'[R, K, 4] tensor, got {tuple(boxes_yxyx.shape)} '
                         f'{boxes_yxyx.dtype}')
    r, k, _ = boxes_yxyx.shape
    if (valid.device != boxes_yxyx.device or valid.dtype != torch.bool
            or tuple(valid.shape) != (r, k) or not valid.is_contiguous()):
        raise ValueError(f'nms_keep_mask: valid must be a contiguous bool '
                         f'[{r}, {k}] tensor on {boxes_yxyx.device}')
    lib = library()
    if k > MAX_K or _smem(lib, r, k) > MAX_SMEM:
        raise ValueError(f'nms_keep_mask: K={k} boxes exceed one block\'s '
                         'shared memory')
    keep = torch.empty((r, k), dtype=torch.bool, device=valid.device)
    with torch.cuda.device(boxes_yxyx.device):
        if boxes_yxyx.device.index not in _ready_devices:
            check(lib.mlk_nms_keep_init(), 'nms_keep_mask')
            _ready_devices.add(boxes_yxyx.device.index)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mlk_nms_keep(boxes_yxyx.data_ptr(), valid.data_ptr(),
                                  keep.data_ptr(), r, k,
                                  float(iou_threshold), int(max_outputs),
                                  stream)
    check(status, 'nms_keep_mask')
    launches += 1
    return keep
