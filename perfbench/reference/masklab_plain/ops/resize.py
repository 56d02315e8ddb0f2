"""Bilinear resize with TF1 semantics, as interpolation matrices.

Port of ``masklab_tpu/ops/resize.py:26-89``. TF1's source coordinate is
``src = i * (in - 1) / (out - 1)`` with align_corners and ``src = i * in /
out`` without. ``F.interpolate(align_corners=False)`` uses half-pixel
centres instead, so it is not used: the port applies the same dense
interpolation matrices as the reference, in float32 (in float64 for a
float64 input).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] bilinear interpolation matrix (TF1)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == in_size:
        np.fill_diagonal(w, 1.0)
        return w
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size if not align_corners else 0.0
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        lo = min(max(lo, 0), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = np.float32(src - lo)
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@functools.lru_cache(maxsize=256)
def _matrix(in_size: int, out_size: int, align_corners: bool,
            device: torch.device) -> torch.Tensor:
    # made outside inference mode: a cached tensor first made while serving
    # must still be usable by a train step's autograd
    with torch.inference_mode(False):
        return torch.from_numpy(
            _interp_matrix(in_size, out_size, align_corners)).to(device)


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The interpolation's type: float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def resize_spatial(x: torch.Tensor, out_h: int, out_w: int,
                   align_corners: bool = True,
                   channels_last: bool = True) -> torch.Tensor:
    """Resize the two spatial axes of ``x``: [..., H, W, C] when
    ``channels_last``, else [..., C, H, W]. Floating inputs keep their
    dtype; integer inputs come back as float32."""
    ah, aw = (-3, -2) if channels_last else (-2, -1)
    in_h, in_w = x.shape[ah], x.shape[aw]
    orig_dtype = x.dtype
    x = x.to(work_dtype(x.dtype))
    if in_h != out_h:
        wh = _matrix(in_h, out_h, align_corners, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, wh, dims=([ah], [1])), -1, ah)
    if in_w != out_w:
        ww = _matrix(in_w, out_w, align_corners, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, ww, dims=([aw], [1])), -1, aw)
    return x.to(orig_dtype) if orig_dtype.is_floating_point else x


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Resize NHWC ``[..., H, W, C]`` to ``[..., out_h, out_w, C]``."""
    return resize_spatial(x, out_h, out_w, align_corners, channels_last=True)


def resize_like(x: torch.Tensor, target: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Resize NHWC ``x`` to NHWC ``target``'s spatial size."""
    return resize_bilinear(x, target.shape[-3], target.shape[-2],
                           align_corners)
