"""K4: the thresholded statistics of the full-frame mask paste, and their
plain version.

Kernel: ``masklab_tpu_torch/csrc/paste_stats.cu``, which replaces no Pallas
kernel: the JAX package reduces the pasted [B, K, H, W] tensor in XLA
(``masklab_tpu/serving/postprocess.py`` ``paste_stats_and_union``). The
kernel visits only each kept box's own pixels and never forms that tensor.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
and an input it cannot take (masks wider than ``MAX_MASK_WIDTH`` columns)
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check, library

launches = 0    # kernel launches since the last reset
WARPS = 8                  # a CTA's warps, each with a mask-wide row buffer
SMEM_BYTES = 48 * 1024     # a launch's shared memory without opting in
TAP_BYTES = 12             # a staged column's taps: two f32 weights, an int
MAX_MASK_WIDTH = 1024      # leaves a chunk of 1344 columns


def paste_span(lo: torch.Tensor, hi: torch.Tensor):
    """The pixels [start, stop) a mask is pasted into for the clipped edges
    [lo, hi), and ``den``, the divisor of its align-corners positions."""
    start = torch.ceil(lo)
    stop = torch.ceil(hi)
    span = torch.clamp(stop - start, min=1.0)
    return start, stop, torch.clamp(span - 1.0, min=1e-6)


def paste_weights(lo: torch.Tensor, hi: torch.Tensor, size: int,
                  mask_size: int) -> torch.Tensor:
    """[..., size, mask_size] matrices pasting a mask row into [lo, hi):
    output pixel y in [ceil(lo), ceil(hi)) samples the mask at the
    align-corners position (y - ceil(lo)) * (mask_size - 1) / (span - 1)."""
    y = torch.arange(size, dtype=torch.float32, device=lo.device)
    start, stop, den = (v[..., None] for v in paste_span(lo, hi))
    pos = (y - start) * (mask_size - 1) / den
    inside = (y >= start) & (y < stop)
    grid = torch.arange(mask_size, dtype=torch.float32, device=lo.device)
    wgt = torch.clamp(1.0 - torch.abs(pos[..., None] - grid), min=0.0)
    return wgt * inside[..., None]


def paste(y1: torch.Tensor, y2: torch.Tensor, x1: torch.Tensor,
          x2: torch.Tensor, keep: torch.Tensor, masks: torch.Tensor,
          hw: Tuple[int, int]) -> torch.Tensor:
    """The masks [B, K, mh, mw] pasted into [y1, y2) x [x1, x2) of an
    ``hw`` frame, times ``keep``: [B, K, H, W] f32, as two GEMMs over the
    paste weights (rows first, then columns)."""
    h, w = hw
    mh, mw = masks.shape[-2:]
    wy = paste_weights(y1, y2, h, mh)                         # [B, K, H, mh]
    wx = paste_weights(x1, x2, w, mw)                         # [B, K, W, mw]
    rows = torch.einsum('bkym,bkmn->bkyn', wy, masks.float())
    full = torch.einsum('bkxn,bkyn->bkyx', wx, rows)          # [B, K, H, W]
    return full * keep[..., None, None]


Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


def paste_reduce_plain(y1: torch.Tensor, y2: torch.Tensor,
                       x1: torch.Tensor, x2: torch.Tensor,
                       keep: torch.Tensor, masks: torch.Tensor,
                       my_road: torch.Tensor,
                       onehot: Optional[torch.Tensor] = None) -> Stats:
    """:func:`paste` thresholded at 0.5, then reduced: (area [B, K] f32,
    inter [B, K] f32 (pixels also on ``my_road``), rowany [B, K, H] bool
    (rows with a pixel), union [B, H, W, C] f32 0/1 of the pixels of each
    class's boxes, or None without ``onehot``).

    y1, y2, x1, x2, keep [B, K] f32 (``serving.postprocess._paste_edges``);
    masks [B, K, mh, mw]; my_road [B, H, W] bool; onehot [B, K, C] 0/1."""
    th = paste(y1, y2, x1, x2, keep, masks, my_road.shape[-2:]) > 0.5
    inter = (my_road[:, None] & th).float().sum((2, 3))
    area = th.float().sum((2, 3))
    union = None
    if onehot is not None:
        union = (torch.einsum('bkhw,bkc->bhwc', th.float(), onehot)
                 > 0.5).float()
    return area, inter, th.any(-1), union


def column_chunk(mask_width: int, width: int) -> int:
    """The columns whose taps a CTA stages at a time, for masks
    ``mask_width`` columns wide in a frame ``width`` pixels wide: as many as
    fit the shared memory beside the warps' mask-wide rows, in whole warps,
    and no more than the frame has. Masks wider than ``MAX_MASK_WIDTH``
    raise."""
    if not 1 <= mask_width <= MAX_MASK_WIDTH:
        raise ValueError(f'paste_stats: masks {mask_width} columns wide; the '
                         f'kernel takes 1 to {MAX_MASK_WIDTH}')
    fit = (SMEM_BYTES - WARPS * mask_width * 4) // TAP_BYTES // 32 * 32
    return min(fit, -(-max(width, 1) // 32) * 32)


def class_bits(onehot: torch.Tensor) -> torch.Tensor:
    """[B, K, C] 0/1 class rows -> [B, K, ceil(C / 32)] int32 words, bit
    c % 32 of word c // 32 for class c (bit 31 is the sign bit)."""
    b, k, c = onehot.shape
    words = -(-c // 32)
    on = torch.zeros((b, k, words * 32), dtype=torch.int64,
                     device=onehot.device)
    on[..., :c] = (onehot > 0.5).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=onehot.device)
    value = (on.view(b, k, words, 32) << shifts).sum(-1)
    return (value - ((value >> 31) << 32)).to(torch.int32)


def union_from_bits(bits: torch.Tensor, classes: int) -> torch.Tensor:
    """[B, H, W, words] int32 words ORed over a pixel's boxes -> the union
    [B, H, W, classes] f32 0/1."""
    c = torch.arange(classes, device=bits.device)
    return ((bits[..., c // 32] >> (c % 32).to(torch.int32)) & 1).float()


def paste_reduce(y1: torch.Tensor, y2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor, keep: torch.Tensor, masks: torch.Tensor,
                 my_road: torch.Tensor,
                 onehot: Optional[torch.Tensor] = None) -> Stats:
    """:func:`paste_reduce_plain`'s outputs without the [B, K, H, W] paste:
    one kernel launch over the kept boxes' own pixels, on the current
    stream. CPU tensors take :func:`paste_reduce_plain`."""
    global launches
    dev = masks.device
    if dev.type == 'cpu':
        return paste_reduce_plain(y1, y2, x1, x2, keep, masks, my_road,
                                  onehot)
    if dev.type != 'cuda':
        raise ValueError(f'paste_stats: unsupported device {dev}')
    if masks.dim() != 4 or my_road.dim() != 3 or my_road.dtype != torch.bool:
        raise ValueError(
            'paste_stats: masks must be [B, K, mh, mw] and my_road a bool '
            f'[B, H, W] tensor, got {tuple(masks.shape)} and '
            f'{tuple(my_road.shape)} {my_road.dtype}')
    b, k, mh, mw = masks.shape
    h, w = my_road.shape[1:]
    if my_road.shape[0] != b:
        raise ValueError(f'paste_stats: {my_road.shape[0]} road maps for '
                         f'{b} images')
    chunk = column_chunk(mw, w)
    tensors = (y1, y2, x1, x2, keep, my_road) + (
        () if onehot is None else (onehot,))
    if any(t.device != dev for t in tensors):
        raise ValueError(f'paste_stats: every input must be on {dev}')
    if any(tuple(t.shape) != (b, k) for t in (y1, y2, x1, x2, keep)):
        raise ValueError(f'paste_stats: box edges and keep must be [{b}, '
                         f'{k}]')
    ys, ye, yden = paste_span(y1.float(), y2.float())
    xs, xe, xden = paste_span(x1.float(), x2.float())
    spans = torch.stack([ys, ye, yden, xs, xe, xden], -1).contiguous()
    keep = keep.float().contiguous()
    masks = masks.float().contiguous()
    road = my_road.contiguous()
    counts = torch.zeros((2, b, k), dtype=torch.int32, device=dev)
    rowany = torch.zeros((b, k, h), dtype=torch.bool, device=dev)
    bits = union_bits = None
    words = 1
    if onehot is not None:
        bits = class_bits(onehot).contiguous()
        words = bits.shape[-1]
        union_bits = torch.zeros((b, h, w, words), dtype=torch.int32,
                                 device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mlk_paste_stats(
            spans.data_ptr(), keep.data_ptr(), masks.data_ptr(),
            road.data_ptr(), 0 if bits is None else bits.data_ptr(),
            counts.data_ptr(), rowany.data_ptr(),
            0 if union_bits is None else union_bits.data_ptr(),
            b, k, h, w, mh, mw, words, chunk, stream)
    check(status, 'paste_stats')
    launches += 1
    union = (None if union_bits is None
             else union_from_bits(union_bits, onehot.shape[-1]))
    area, inter = counts.float().unbind(0)
    return area, inter, rowany, union
