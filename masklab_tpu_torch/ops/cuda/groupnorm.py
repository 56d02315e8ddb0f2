"""K1: flat-band GroupNorm for ragged maps, its backward, and their plain
versions.

Kernels: ``masklab_tpu_torch/csrc/band_groupnorm.cu``, in place of the Pallas
``band_groupnorm_pallas`` and of the XLA backward ``_bgn_bwd`` of its
``custom_vjp`` (``masklab_tpu/ops/pallas/groupnorm_kernel.py``).
``BandGroupNormFn`` ties the two into one differentiable op. A CPU tensor
takes the plain versions; a CUDA tensor launches the kernels.
"""
from __future__ import annotations

import torch

from ._build import check, library

launches = 0            # forward kernel launches since the last reset
backward_launches = 0   # backward calls since then (one kernel each on the
                        # warp path; the scalar path adds a reduce kernel)
_tickets = {}           # (device, stream) -> the backward's int32 ticket


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


def _check_map(name: str, x: torch.Tensor, groups: int, params) -> None:
    """Raise unless x is a contiguous [N, Q, C] f32/bf16 map with C % G == 0
    and every tensor of ``params`` a contiguous f32 [C] on x's device."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{name}: x must be [N, Q, C] float32 or bfloat16, '
                         f'got {tuple(x.shape)} {x.dtype}')
    n, q, c = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f'{name}: {c} channels not divisible by {groups} '
                         'groups')
    for pname, t in params:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f'{name}: {pname} must be a contiguous float32 '
                             f'[{c}] tensor on {x.device}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: x must be contiguous')
    if n * groups >= 2 ** 31:
        raise ValueError(f'{name}: too many bands for one launch')


def band_groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5,
                   fuse_relu: bool = False) -> torch.Tensor:
    """Flat-band GroupNorm over [N, Q, C] (f32 or bf16, contiguous) with
    float32 ``scale``/``bias`` [C]; relu on the input first when
    ``fuse_relu``. CPU tensors take :func:`band_groupnorm_plain`."""
    global launches
    if x.device.type == 'cpu':
        return band_groupnorm_plain(x, scale, bias, groups, eps, fuse_relu)
    if x.device.type != 'cuda':
        raise ValueError(f'band_groupnorm: unsupported device {x.device}')
    _check_map('band_groupnorm', x, groups, (('scale', scale),
                                             ('bias', bias)))
    n, q, c = x.shape
    y = torch.empty_like(x)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mlk_band_groupnorm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, q, c, groups, float(eps), int(fuse_relu),
            0 if x.dtype == torch.float32 else 1, stream)
    check(status, 'band_groupnorm')
    launches += 1
    return y


def band_groupnorm_backward(x: torch.Tensor, dy: torch.Tensor,
                            scale: torch.Tensor, groups: int,
                            eps: float = 1e-5, fuse_relu: bool = False):
    """The backward of :func:`band_groupnorm` -> (dx, dscale, dbias): x and
    dy [N, Q, C] of one type (f32 or bf16, contiguous), ``scale`` f32 [C].
    CPU tensors take :func:`band_groupnorm_backward_plain`; a CUDA tensor
    launches the kernel: one persistent launch that also adds the
    parameter gradients over N in a fixed order, where the map is whole
    aligned 16-byte vectors (every map of the train path); else a band
    pass and a fixed-order reduce over N. The warp path's ticket is one
    zeroed integer per device and stream, kept here, which every call
    leaves at 0."""
    global backward_launches
    if x.device.type == 'cpu':
        return band_groupnorm_backward_plain(x, dy, scale, groups, eps,
                                             fuse_relu)
    if x.device.type != 'cuda':
        raise ValueError('band_groupnorm_backward: unsupported device '
                         f'{x.device}')
    _check_map('band_groupnorm_backward', x, groups, (('scale', scale),))
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError('band_groupnorm_backward: dy must be a contiguous '
                         f'{x.dtype} {tuple(x.shape)} tensor on {x.device}')
    n, q, c = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    partials = torch.empty(2 * n * c, dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (x.device.index, stream)
        if key not in _tickets:
            _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                        device=x.device)
        status = lib.mlk_band_groupnorm_backward(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
            _tickets[key].data_ptr(), n, q, c, groups, float(eps),
            int(fuse_relu), 0 if x.dtype == torch.float32 else 1, stream)
    check(status, 'band_groupnorm_backward')
    backward_launches += 1
    return dx, dscale, dbias


class BandGroupNormFn(torch.autograd.Function):
    """Differentiable flat-band GroupNorm: the forward is
    :func:`band_groupnorm`, the backward :func:`band_groupnorm_backward`
    (the kernels on the card, the plain versions on the CPU). The counterpart
    of the reference's ``custom_vjp`` ``band_groupnorm``."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float = 1e-5,
                fuse_relu: bool = False):
        ctx.save_for_backward(x, scale)
        ctx.groups, ctx.eps, ctx.fuse_relu = groups, eps, fuse_relu
        return band_groupnorm(x, scale, bias, groups, eps, fuse_relu)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = band_groupnorm_backward(
            x, dy.contiguous(), scale, ctx.groups, ctx.eps, ctx.fuse_relu)
        return dx, dscale, dbias, None, None, None
