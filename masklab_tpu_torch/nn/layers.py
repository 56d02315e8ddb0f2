"""Core modules shared across the heads.

Port of ``masklab_tpu/nn/layers.py``. Modules take and return NCHW tensors
that are ``channels_last`` in memory, so the NHWC view the flat-band
GroupNorm needs is a free ``permute``. Submodules carry the flax module
names of the reference (``Conv_0``, ``GroupNorm_0``, ...), so the weight
bridge (``masklab_tpu_torch/weights.py``) maps parameters by path.

Parameters are float32 whatever the compute dtype, as flax keeps
``param_dtype=float32``: ``Conv2d`` and ``Linear`` cast their weights (and
inputs) to the compute dtype inside each call, so a bf16 model trains an f32
master copy and serves with the weights rounded exactly as loading them into
bf16 would; the predictor casts them once instead (``hold_compute_dtype``).
``BatchNorm`` normalizes with batch statistics in train mode
(``model.train()``) and with its running statistics in eval mode.

Within ``nn.spatial.spatially_sharded`` (the dp x sp step) each module
runs on this rank's block of rows: ``Conv2d`` takes its halo rows (zeros
only at the frame's top and bottom), the stride-2 pads follow the frame's
parity, GroupNorm's bands and BatchNorm's and the squeeze-excite's means
are sums over the ranks, and a GroupNorm map that is ragged for the whole
frame goes whole to K1, as one process's does.

``SqueezeExcite`` gates the inputs of the heads' convs in the road preset;
``MobileSeparableConv`` makes up the separable heads
(``use_separable_conv``). Not ported here: the space-to-depth ``StemConv``
(a TPU form of the plain stride-2 stem conv).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import BandGroupNormFn
from ..ops.cuda import batch_norm_act as bna
from . import spatial
from .sync import all_reduce_sum


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters, computed in ``compute_dtype``
    (weight, bias and input cast inside the call, like flax's ``nn.Conv``
    with ``dtype`` and ``param_dtype=float32``). Sharded, a conv with rows
    to look at beyond its own (a k x k kernel, a row stride, row padding,
    a stride-2 pad's ``spatial.RowPad``) runs ``spatial.conv_rows``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        pad_mode = None
        if isinstance(x, spatial.RowPad):
            x, pad_mode = x.tensor, x
        dt = self.compute_dtype
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        sp = spatial.active()
        if sp is not None:
            if (pad_mode is not None or self.kernel_size[0] > 1
                    or self.stride[0] > 1 or self.padding[0]):
                return spatial.conv_rows(sp, self, x, w, b, self.stride,
                                         self.padding, self.dilation,
                                         self.groups, pad_mode=pad_mode)
            if x.shape[-2] == 0:
                return spatial.empty_conv(
                    lambda t: self._conv_forward(t, w, b), x)
        return self._conv_forward(x, w, b)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters, computed in ``compute_dtype``
    (flax's ``nn.Dense`` with ``dtype``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


def hold_compute_dtype(model: nn.Module) -> nn.Module:
    """Cast, in place and once, the parameters of every module that computes
    in a ``compute_dtype`` (convs, the transposed conv, the squeeze-excite
    denses) to that dtype, so a model that only serves skips the cast in
    each call. The outputs are the same bits; GroupNorm and BatchNorm keep
    float32. A model held so is for inference, not for training."""
    for m in model.modules():
        dt = getattr(m, 'compute_dtype', None)
        if dt is not None:
            m.to(dt)
    return model


def conv2d(in_ch: int, out_ch: int, kernel: int, bias: bool = True,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1, dtype=torch.float32) -> Conv2d:
    """A conv computed in ``dtype`` with float32 parameters. flax's SAME for
    the stride-1 odd kernels used here is the symmetric
    ``padding=dilation*(k-1)//2``."""
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=bias,
                  compute_dtype=dtype)


def same_conv(in_ch: int, out_ch: int, kernel: int, bias: bool = True,
              dilation: int = 1, groups: int = 1,
              dtype=torch.float32) -> Conv2d:
    return conv2d(in_ch, out_ch, kernel, bias=bias,
                  padding=dilation * (kernel - 1) // 2, dilation=dilation,
                  groups=groups, dtype=dtype)


def pad_valid_s2(x: torch.Tensor) -> torch.Tensor:
    """Keras stride-2 padding: zero-pad bottom/right by one (NCHW). Sharded,
    the width is padded and the rows' (0, 1) is left to the conv: the
    result, a ``spatial.RowPad``, must go straight to a ``Conv2d`` (only
    the frame's last rank pads)."""
    if spatial.active() is not None:
        return spatial.RowPad(F.pad(x, (0, 1)), 'valid')
    return F.pad(x, (0, 1, 0, 1))


def pad_same_s2(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """XLA 'SAME' padding of a k x k stride-2 conv (NCHW): each spatial axis
    of size n gets ceil(n / 2) outputs and max((ceil(n / 2) - 1) * 2 + k -
    n, 0) zeros, the smaller half before. For k = 3: (0, 1) on an even axis
    and (1, 1) on an odd one; for k = 5: (1, 2) and (2, 2)
    (``spatial.same_pads``). Sharded, the width is padded and the rows'
    pads, from the frame's parity, are left to the conv: the result, a
    ``spatial.RowPad``, must go straight to a ``Conv2d``."""
    cols = spatial.same_pads(x.shape[-1], kernel)
    if spatial.active() is not None:
        return spatial.RowPad(F.pad(x, cols), 'same', kernel)
    return F.pad(x, cols + spatial.same_pads(x.shape[-2], kernel))


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             site=None, zero_pad: bool = False) -> torch.Tensor:
    """``F.max_pool2d`` with ``padding`` (-inf, or zeros padded first with
    ``zero_pad``); sharded, ``spatial.pool_rows`` at ``site``."""
    sp = spatial.active()
    if sp is not None:
        return spatial.pool_rows(sp, site, x, kernel, stride, padding,
                                 0.0 if zero_pad else -math.inf)
    if zero_pad:
        return F.max_pool2d(F.pad(x, (padding,) * 4), kernel, stride=stride)
    return F.max_pool2d(x, kernel, stride=stride, padding=padding)


class GroupNorm(nn.Module):
    """The reference's flat-band GroupNorm (``masklab_tpu/nn/layers.py:28``).

    NOT ``torch.nn.GroupNorm``: the NHWC map is flattened per sample and
    each group is a contiguous band of H*W*C/G elements; statistics are f32
    E[x], E[x^2] over the band and the affine is per (band, c mod C/G).
    When G divides H*W the band is the strip view [B, G, HW/G, C] (plain
    torch); ragged maps go through ``band_groupnorm`` (kernel K1 on the
    card, with K1's backward kernel as its gradient: ``BandGroupNormFn``).
    ``forward(x, fuse_relu=True)`` applies relu to the input first.
    Sharded, the raggedness is the frame's map's: a band of a strip map
    spans the ranks' blocks, its float32 sums are summed over the ranks;
    a ragged map is gathered whole to K1 (as GSPMD runs a ``pallas_call``
    it cannot partition) and each rank keeps its rows. The statistics are
    float32, the reference's (float64 for a float64 map).
    """

    def __init__(self, channels: int, groups: int = 16):
        super().__init__()
        self.groups = min(groups, channels)
        if channels % self.groups:
            raise ValueError(f'channels {channels} not divisible by '
                             f'{self.groups} groups')
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, fuse_relu: bool = False):
        sp = spatial.active()
        if sp is None:
            return self._whole(x, fuse_relu)
        rows = sp.rows(self, x.shape[2])
        if rows * x.shape[3] % self.groups:
            a, e = sp.block(rows)
            return self._whole(spatial.gather(x, self), fuse_relu)[:, :, a:e]
        return self._strips(sp, x, rows, fuse_relu)

    def _tables(self, c: int):
        cg = c // self.groups
        return (self.weight.reshape(self.groups, cg).repeat(1, c // cg),
                self.bias.reshape(self.groups, cg).repeat(1, c // cg))

    def _strips(self, sp, x: torch.Tensor, rows: int, fuse_relu: bool):
        """This rank's rows of a strip map: its pixels padded with zeros to
        whole bands, each band's sums over the ranks."""
        b, c, h, w = x.shape
        groups = self.groups
        per = rows * w // groups
        a, e = sp.block(rows)
        p0, p1 = a * w, e * w
        g0, g1 = (p0 // per, -(-p1 // per)) if p1 > p0 else (0, 0)
        front, back = p0 - g0 * per, g1 * per - p1
        nhwc = x.permute(0, 2, 3, 1)
        if fuse_relu:
            nhwc = torch.relu(nhwc)
        g = F.pad(nhwc.reshape(b, h * w, c), (0, 0, front, back)).reshape(
            b, g1 - g0, per, c)
        f32 = g.to(torch.promote_types(x.dtype, torch.float32))
        sums = torch.stack([f32.sum((2, 3)), f32.square().sum((2, 3))], -1)
        sums = all_reduce_sum(F.pad(sums, (0, 0, g0, groups - g1)),
                              sp.sp.group)[:, g0:g1] / (per * c)
        m1, m2 = sums[..., 0, None, None], sums[..., 1, None, None]
        inv = torch.rsqrt(torch.clamp(m2 - m1 * m1, min=0.0) + 1e-5)
        y = (g - m1.to(x.dtype)) * inv.to(x.dtype)
        table_s, table_b = (t[g0:g1] for t in self._tables(c))
        y = (y * table_s[None, :, None, :].to(x.dtype)
             + table_b[None, :, None, :].to(x.dtype))
        y = y.reshape(b, (g1 - g0) * per, c)[:, front:front + h * w]
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def _whole(self, x: torch.Tensor, fuse_relu: bool):
        b, c, h, w = x.shape
        groups, spatial_size = self.groups, h * w
        nhwc = x.permute(0, 2, 3, 1)
        if spatial_size % groups:
            y = BandGroupNormFn.apply(
                nhwc.reshape(b, spatial_size, c).contiguous(), self.weight,
                self.bias, groups, 1e-5, fuse_relu)
            return y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if fuse_relu:
            nhwc = torch.relu(nhwc)
        g = nhwc.reshape(b, groups, spatial_size // groups, c)
        f32 = g.to(torch.promote_types(x.dtype, torch.float32))
        m1 = f32.mean((2, 3), keepdim=True)
        m2 = f32.square().mean((2, 3), keepdim=True)
        inv = torch.rsqrt(torch.clamp(m2 - m1 * m1, min=0.0) + 1e-5)
        y = (g - m1.to(x.dtype)) * inv.to(x.dtype)
        table_s, table_b = self._tables(c)
        y = (y * table_s[None, :, None, :].to(x.dtype)
             + table_b[None, :, None, :].to(x.dtype))
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_running_average=not train)``, computed like
    it: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 (or in
    x's type where that is wider, as flax promotes), cast back.
    Eval mode uses the running statistics. Train mode uses the batch's, f32
    reductions over (N, H, W) with flax's fast variance max(E[x^2] - E[x]^2,
    0) (biased), and updates the running ones as ``r = momentum * r + (1 -
    momentum) * batch`` with that same biased variance (``F.batch_norm``
    would store the unbiased one, and weighs its momentum the other way).
    ``use_scale=False`` has no scale (``weight`` is None). While
    ``update_stats`` is False a train-mode call leaves the running
    statistics alone: the recomputation of a checkpointed forward
    (``frozen_batch_stats``) must not apply the momentum update twice.
    While ``sync`` holds a data-parallel group (``nn.sync.synchronized``),
    train mode takes the statistics of the global batch: the float32 sums
    of x and x^2 over the rank's (N, H, W), summed over the ranks with
    their gradients (every rank holds as many rows). Sharded
    (``nn.spatial``), the sums cross every rank of the mesh and divide by
    the global count (the ranks' blocks may differ in rows).

    ``forward(x, act=None, residual=None)`` also runs what follows the
    BatchNorm at its call site: ``+ residual``, then ``act`` ('relu' or
    'silu'). In eval mode on a CUDA tensor the whole chain is K5
    (``ops.cuda.batch_norm_act``), one read and one write of the map with
    the plain chain's bits; on the CPU, and in train mode, separate
    PyTorch ops."""

    def __init__(self, channels: int, eps: float = 1e-3,
                 use_scale: bool = True, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.sync = None
        self.weight = (nn.Parameter(torch.ones(channels)) if use_scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor, act=None,
                residual=None) -> torch.Tensor:
        if not self.training:
            return self._eval(x, act, residual)
        shape = (1, -1, 1, 1)
        f = x.to(torch.promote_types(x.dtype, torch.float32))
        sp = spatial.active()
        if sp is not None:
            c = f.shape[1]
            count = (f.shape[0] * sp.dp.world * f.shape[3]
                     * sp.rows(self, f.shape[2]))
            sums = all_reduce_sum(torch.cat(
                [f.sum((0, 2, 3)), f.square().sum((0, 2, 3))]),
                sp.world.group) / count
            mean, mean_sq = sums[:c], sums[c:]
        elif self.sync is None:
            mean = f.mean((0, 2, 3))
            mean_sq = f.square().mean((0, 2, 3))
        else:
            c = f.shape[1]
            sums = all_reduce_sum(torch.cat(
                [f.sum((0, 2, 3)), f.square().sum((0, 2, 3))]),
                self.sync.group) / (f.numel() // c * self.sync.world)
            mean, mean_sq = sums[:c], sums[c:]
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        mul = self._mul(var)
        y = (f - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return bna.epilogue(y.to(x.dtype), residual, act)

    def _eval(self, x: torch.Tensor, act, residual) -> torch.Tensor:
        """The running statistics' chain (``ops.cuda.batch_norm_act``)."""
        return bna.batch_norm_act(x, self.running_mean,
                                  self._mul(self.running_var), self.bias,
                                  residual, act)

    def _mul(self, var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        return mul


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Within the block, the BatchNorms of ``module`` leave their running
    statistics alone in train mode."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class SqueezeExcite(nn.Module):
    """Channel attention (``masklab_tpu/nn/layers.py:244-261``): the
    spatial mean of each map -> bias-free Dense to ``int(c // ratio)`` ->
    relu -> bias-free Dense to c -> sigmoid, which scales the channels."""

    def __init__(self, channels: int, ratio: float = 16.0,
                 dtype=torch.float32):
        super().__init__()
        hidden = int(channels // ratio)
        self.Dense_0 = Linear(channels, hidden, bias=False,
                              compute_dtype=dtype)
        self.Dense_1 = Linear(hidden, channels, bias=False,
                              compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = torch.relu(self.Dense_0(spatial.mean_hw(x, self)))
        se = torch.sigmoid(self.Dense_1(se))
        return x * se[:, :, None, None]


class AtrousSeparableConv(nn.Module):
    """Dilated depthwise 3x3 + GN + ReLU, then pointwise + GN + ReLU."""

    def __init__(self, in_ch: int, filters: int, dilation_rate: int = 3,
                 groups: int = 16, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = same_conv(in_ch, in_ch, 3, bias=False,
                                dilation=dilation_rate, groups=in_ch,
                                dtype=dtype)
        self.GroupNorm_0 = GroupNorm(in_ch, groups)
        self.Conv_1 = conv2d(in_ch, filters, 1, bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(filters, groups)

    def forward(self, x):
        x = self.GroupNorm_0(self.Conv_0(x))
        x = self.Conv_1(torch.relu(x))
        return torch.relu(self.GroupNorm_1(x))


class MobileSeparableConv(nn.Module):
    """Inverted-residual separable conv (``masklab_tpu/nn/layers.py:264-
    289``): 1x1 expand to ``int(expand_ratio * filters)`` -> GroupNorm ->
    relu -> depthwise k x k -> GroupNorm -> relu -> 1x1 to ``filters`` ->
    GroupNorm, added to the input. The add needs the input to have
    ``filters`` channels; the reference fails there too otherwise. Each
    GroupNorm is the flat-band one, so a ragged map takes K1."""

    def __init__(self, in_ch: int, filters: int, kernel_size: int = 3,
                 expand_ratio: float = 4.0, groups: int = 16,
                 dtype=torch.float32):
        super().__init__()
        if in_ch != filters:
            raise ValueError(
                f'MobileSeparableConv adds its input ({in_ch} channels) to '
                f'its output ({filters}): the widths must match')
        expanded = int(expand_ratio * filters)
        self.Conv_0 = conv2d(in_ch, expanded, 1, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(expanded, groups)
        self.Conv_1 = same_conv(expanded, expanded, kernel_size, bias=False,
                                groups=expanded, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(expanded, groups)
        self.Conv_2 = conv2d(expanded, filters, 1, bias=False, dtype=dtype)
        self.GroupNorm_2 = GroupNorm(filters, groups)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv_1(y)))
        return x + self.GroupNorm_2(self.Conv_2(y))


class HeadBlock(nn.Module):
    """``num_depth`` x [SqueezeExcite? -> Conv3x3 -> ReLU -> GroupNorm],
    the shared body of the cls/loc, mask and segmentation heads. The relu
    rides inside the GroupNorm (K1's fuse_relu on ragged maps). Each
    SqueezeExcite pools its own sample, so in the mask heads each RoI crop
    alone. With ``use_separable_conv`` each layer is instead
    [SqueezeExcite? -> MobileSeparableConv -> GroupNorm] (no relu), named
    ``MobileSeparableConv_{i}`` / ``GroupNorm_{i}`` as the reference's
    auto-numbered modules."""

    def __init__(self, in_ch: int, num_depth: int = 4,
                 num_features: int = 256, groups: int = 16,
                 dtype=torch.float32, use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0,
                 use_separable_conv: bool = False,
                 expand_ratio: float = 4.0):
        super().__init__()
        self.num_depth = num_depth
        self.use_squeeze_excite = use_squeeze_excite
        self.use_separable_conv = use_separable_conv
        for i in range(num_depth):
            ch = in_ch if i == 0 else num_features
            if use_squeeze_excite:
                self.add_module(f'SqueezeExcite_{i}', SqueezeExcite(
                    ch, squeeze_ratio, dtype))
            if use_separable_conv:
                self.add_module(f'MobileSeparableConv_{i}',
                                MobileSeparableConv(ch, num_features, 3,
                                                    expand_ratio, groups,
                                                    dtype))
            else:
                self.add_module(f'Conv_{i}', same_conv(ch, num_features, 3,
                                                       dtype=dtype))
            self.add_module(f'GroupNorm_{i}', GroupNorm(num_features, groups))

    def forward(self, x):
        for i in range(self.num_depth):
            if self.use_squeeze_excite:
                x = getattr(self, f'SqueezeExcite_{i}')(x)
            if self.use_separable_conv:
                x = getattr(self, f'MobileSeparableConv_{i}')(x)
                x = getattr(self, f'GroupNorm_{i}')(x)
            else:
                x = getattr(self, f'Conv_{i}')(x)
                x = getattr(self, f'GroupNorm_{i}')(x, fuse_relu=True)
        return x
