"""K2: per-segment top-`cap` extraction, and its plain version.

Kernel: ``masklab_tpu_torch/csrc/segment_topk.cu``, in place of the Pallas
``segment_topk_pallas`` (``masklab_tpu/ops/pallas/topk_kernel.py``).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import torch

from ._build import check, library

launches = 0   # kernel launches since the last reset
MAX_CAP = 16
SEGMENT_ROWS = 128   # m: rows of the strided [m, s] view of a score row
MAX_ROWS = 256       # the kernel's largest m


def segment_topk_plain(x: torch.Tensor, cap: int):
    """Per-column top-``cap`` of [R, m, s] rows (column j = segment j):
    ``cap`` rounds of (max, lowest argmax, mask), the reference's XLA form
    (``masklab_tpu/ops/nms.py:241-255``). Returns (vals [R, cap, s] f32,
    idx [R, cap, s] int32) with idx = row * s + j."""
    r, m, s = x.shape
    work = x.float().transpose(1, 2).contiguous()           # [R, s, m]
    lane = torch.arange(s, device=x.device)
    vals, idxs = [], []
    for _ in range(cap):
        am = work.argmax(-1, keepdim=True)                  # first maximum
        vals.append(work.gather(-1, am)[..., 0])
        idxs.append(am[..., 0] * s + lane)
        work.scatter_(-1, am, float('-inf'))
    return (torch.stack(vals, 1),
            torch.stack(idxs, 1).to(torch.int32))


def segment_topk_rows_plain(scores: torch.Tensor, cap: int,
                            m: int = SEGMENT_ROWS):
    """:func:`segment_topk_rows` by a padded copy of the rows, -inf to
    m * ceil(n / m), viewed as [R, m, s] for :func:`segment_topk_plain`."""
    n = scores.shape[-1]
    s = -(-n // m)
    rows = scores.float().reshape(-1, n)
    pad = rows.new_full((rows.shape[0], m * s - n), float('-inf'))
    return segment_topk_plain(torch.cat([rows, pad], 1).reshape(-1, m, s),
                              cap)


def _group_view(scores: torch.Tensor) -> torch.Tensor:
    """``scores`` [..., n] as a [R0, G, n] view, R = R0 * G rows in order.
    G is the second-to-last dimension where its stride is below the
    element stride (the transpose of a [B, N, C] tensor: a block then reads
    all C rows of a run of columns as one contiguous span), else 1."""
    n = scores.shape[-1]
    if scores.dim() >= 2 and scores.stride(-2) < scores.stride(-1):
        return scores.reshape(-1, scores.shape[-2], n)
    return scores.reshape(-1, 1, n)


def segment_topk_rows(scores: torch.Tensor, cap: int, m: int = SEGMENT_ROWS):
    """Per-segment top-``cap`` of float32 [..., n] score rows with any
    strides, read in place (up to three dimensions; more leading ones are
    merged, by a copy where their strides do not allow a view): equal to
    :func:`segment_topk` on the rows padded with -inf to m * s
    (s = ceil(n / m)) and viewed as [R, m, s]. Returns (vals [R, cap, s]
    f32, idx [R, cap, s] int32), R the product of the leading dimensions.
    CPU tensors take the plain version."""
    if scores.device.type == 'cpu':
        return segment_topk_rows_plain(scores, cap, m)
    if scores.device.type != 'cuda':
        raise ValueError(f'segment_topk: unsupported device {scores.device}')
    if scores.dtype != torch.float32 or scores.dim() < 1:
        raise ValueError('segment_topk: scores must be float32 [..., n], got '
                         f'{tuple(scores.shape)} {scores.dtype}')
    return _launch(_group_view(scores), cap, m)


def segment_topk(x: torch.Tensor, cap: int):
    """Per-segment top-``cap`` of float32 [R, m, s] score rows, already
    padded; see :func:`segment_topk_plain`. CPU tensors take the plain
    version."""
    if x.device.type == 'cpu':
        return segment_topk_plain(x, cap)
    if x.device.type != 'cuda':
        raise ValueError(f'segment_topk: unsupported device {x.device}')
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError('segment_topk: x must be a contiguous float32 '
                         f'[R, m, s] tensor, got {tuple(x.shape)} {x.dtype}')
    r, m, s = x.shape
    return _launch(x.view(r, 1, m * s), cap, m)


def _launch(x3: torch.Tensor, cap: int, m: int):
    """The kernel on a [R0, G, n] view: (vals, idx) [R0 * G, cap, s]."""
    global launches
    r0, g, n = x3.shape
    s = -(-n // m)
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f'segment_topk: cap must be in 1..{MAX_CAP}')
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f'segment_topk: m must be in 1..{MAX_ROWS}')
    if r0 > 65535 or m * s >= 2 ** 31 or g * s >= 2 ** 31:
        raise ValueError(f'segment_topk: shape {tuple(x3.shape)} too large')
    vals = torch.empty((r0 * g, cap, s), dtype=torch.float32,
                       device=x3.device)
    idx = torch.empty((r0 * g, cap, s), dtype=torch.int32, device=x3.device)
    lib = library()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mlk_segment_topk(
            x3.data_ptr(), vals.data_ptr(), idx.data_ptr(), r0, g,
            x3.stride(0), x3.stride(1), x3.stride(2), n, m, s, cap, stream)
    check(status, 'segment_topk')
    launches += 1
    return vals, idx
