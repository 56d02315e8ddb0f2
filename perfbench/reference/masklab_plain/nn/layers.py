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

``SqueezeExcite`` gates the inputs of the heads' convs in the road preset.
Only what the benchmark's configurations run is kept: one process, no
spatial sharding, no separable heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.plain_kernels import BandGroupNormFn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters, computed in ``compute_dtype``
    (weight, bias and input cast inside the call, like flax's ``nn.Conv``
    with ``dtype`` and ``param_dtype=float32``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters, computed in ``compute_dtype``
    (flax's ``nn.Dense`` with ``dtype``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


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


def same_pads(n: int, kernel: int):
    """XLA 'SAME' padding of a k x k stride-2 conv on an axis of ``n``:
    ceil(n / 2) outputs, max((ceil(n / 2) - 1) * 2 + k - n, 0) zeros, the
    smaller half before."""
    total = max((-(-n // 2) - 1) * 2 + kernel - n, 0)
    return total // 2, total - total // 2


def pad_valid_s2(x: torch.Tensor) -> torch.Tensor:
    """Keras stride-2 padding: zero-pad bottom/right by one (NCHW)."""
    return F.pad(x, (0, 1, 0, 1))


def pad_same_s2(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """XLA 'SAME' padding of a k x k stride-2 conv (NCHW): each spatial axis
    of size n gets ``same_pads``' zeros. For k = 3: (0, 1) on an even axis
    and (1, 1) on an odd one; for k = 5: (1, 2) and (2, 2)."""
    return F.pad(x, same_pads(x.shape[-1], kernel)
                 + same_pads(x.shape[-2], kernel))


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             zero_pad: bool = False) -> torch.Tensor:
    """``F.max_pool2d`` with ``padding`` (-inf, or zeros padded first with
    ``zero_pad``)."""
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
    ``forward(x, fuse_relu=True)`` applies relu to the input first. The
    statistics are float32 (float64 for a float64 map).
    """

    def __init__(self, channels: int, groups: int = 16):
        super().__init__()
        self.groups = min(groups, channels)
        if channels % self.groups:
            raise ValueError(f'channels {channels} not divisible by '
                             f'{self.groups} groups')
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _tables(self, c: int):
        cg = c // self.groups
        return (self.weight.reshape(self.groups, cg).repeat(1, c // cg),
                self.bias.reshape(self.groups, cg).repeat(1, c // cg))

    def forward(self, x: torch.Tensor, fuse_relu: bool = False):
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
    ``use_scale=False`` has no scale (``weight`` is None)."""

    def __init__(self, channels: int, eps: float = 1e-3,
                 use_scale: bool = True, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = (nn.Parameter(torch.ones(channels)) if use_scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        f = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = f.mean((0, 2, 3))
            mean_sq = f.square().mean((0, 2, 3))
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (f - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


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
        se = torch.relu(self.Dense_0(x.mean((-2, -1))))
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


class HeadBlock(nn.Module):
    """``num_depth`` x [SqueezeExcite? -> Conv3x3 -> ReLU -> GroupNorm],
    the shared body of the cls/loc, mask and segmentation heads. The relu
    rides inside the GroupNorm (K1's fuse_relu on ragged maps). Each
    SqueezeExcite pools its own sample, so in the mask heads each RoI crop
    alone."""

    def __init__(self, in_ch: int, num_depth: int = 4,
                 num_features: int = 256, groups: int = 16,
                 dtype=torch.float32, use_squeeze_excite: bool = False,
                 squeeze_ratio: float = 16.0):
        super().__init__()
        self.num_depth = num_depth
        self.use_squeeze_excite = use_squeeze_excite
        for i in range(num_depth):
            ch = in_ch if i == 0 else num_features
            if use_squeeze_excite:
                self.add_module(f'SqueezeExcite_{i}', SqueezeExcite(
                    ch, squeeze_ratio, dtype))
            self.add_module(f'Conv_{i}', same_conv(ch, num_features, 3,
                                                   dtype=dtype))
            self.add_module(f'GroupNorm_{i}', GroupNorm(num_features, groups))

    def forward(self, x):
        for i in range(self.num_depth):
            if self.use_squeeze_excite:
                x = getattr(self, f'SqueezeExcite_{i}')(x)
            x = getattr(self, f'Conv_{i}')(x)
            x = getattr(self, f'GroupNorm_{i}')(x, fuse_relu=True)
        return x
