"""The three kernels' plain versions (K1 flat-band GroupNorm and its
backward, K2 segment top-k, K3 greedy NMS keep-mask), on any device:
the reference launches no kernel of its own."""
from __future__ import annotations

import torch

from .boxes import iou_yxyx

SEGMENT_ROWS = 128   # m: rows of the strided [m, s] view of a score row


def band_groupnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-5,
                         fuse_relu: bool = False) -> torch.Tensor:
    """Flat-band GroupNorm over [N, Q, C], the ragged branch of the
    reference (``masklab_tpu/nn/layers.py:121-133``): f32 statistics (f64
    for a float64 map) per contiguous band of Q*C/G flat elements,
    normalize and the periodic per-(band, c mod C/G) affine in
    ``x.dtype``."""
    if fuse_relu:
        x = torch.relu(x)
    n, q, c = x.shape
    cg = c // groups
    flat = x.reshape(n, groups, -1)
    f32 = flat.to(torch.promote_types(x.dtype, torch.float32))
    m1 = f32.mean(-1, keepdim=True)
    m2 = f32.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(m2 - m1 * m1, min=0.0) + eps)
    y = (flat - m1.to(x.dtype)) * inv.to(x.dtype)
    length = flat.shape[-1]
    # band position p maps to channel g*cg + (p % cg)
    table_s = scale.reshape(groups, cg).repeat(1, length // cg)
    table_b = bias.reshape(groups, cg).repeat(1, length // cg)
    y = y * table_s[None].to(x.dtype) + table_b[None].to(x.dtype)
    return y.reshape(n, q, c)


def band_groupnorm_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                                  scale: torch.Tensor, groups: int,
                                  eps: float = 1e-5, fuse_relu: bool = False):
    """The exact flat-band gradient of :func:`band_groupnorm_plain` as the
    reference's ``_bgn_bwd`` computes it
    (``masklab_tpu/ops/pallas/groupnorm_kernel.py:208-251``), in f32 (f64
    for a float64 map):
    ``dx = inv * (g - mean(g) - x^ * mean(g * x^))`` per band with
    ``g = dy * s_e``, cast once to ``x.dtype`` and, with ``fuse_relu``,
    zero where ``x <= 0``; ``dscale`` / ``dbias`` (f32) sum ``dy * x^`` /
    ``dy`` over every element that shares (band, c mod C/G).
    Returns (dx, dscale, dbias)."""
    n, q, c = x.shape
    cg = c // groups
    acc = torch.promote_types(x.dtype, torch.float32)
    f = x.to(acc).reshape(n, groups, -1)
    if fuse_relu:
        f = torch.relu(f)
    length = f.shape[-1]
    m1 = f.mean(-1, keepdim=True)
    m2 = f.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(m2 - m1 * m1, min=0.0) + eps)
    xhat = (f - m1) * inv
    dyf = dy.to(acc).reshape(n, groups, -1)
    g = dyf * scale.to(acc).reshape(groups, cg).repeat(1, length // cg)
    dxf = inv * (g - g.mean(-1, keepdim=True)
                 - xhat * (g * xhat).mean(-1, keepdim=True))
    if fuse_relu:
        dxf = torch.where(x.reshape(n, groups, -1) > 0, dxf, 0.0)

    def per_channel(t):
        return t.reshape(n, groups, length // cg, cg).sum((0, 2)).reshape(c)
    return (dxf.to(x.dtype).reshape(n, q, c), per_channel(dyf * xhat),
            per_channel(dyf))


class BandGroupNormFn(torch.autograd.Function):
    """Differentiable flat-band GroupNorm through the plain versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float = 1e-5,
                fuse_relu: bool = False):
        ctx.save_for_backward(x, scale)
        ctx.groups, ctx.eps, ctx.fuse_relu = groups, eps, fuse_relu
        return band_groupnorm_plain(x, scale, bias, groups, eps, fuse_relu)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = band_groupnorm_backward_plain(
            x, dy.contiguous(), scale, ctx.groups, ctx.eps, ctx.fuse_relu)
        return dx, dscale, dbias, None, None, None


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


segment_topk_rows = segment_topk_rows_plain
nms_keep_mask = nms_keep_mask_plain
