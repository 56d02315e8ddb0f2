"""K5: eval BatchNorm with the residual add and the activation after it, in
one pass, and its plain version.

Kernel: ``masklab_tpu_torch/csrc/batch_norm_act.cu``, which replaces no
Pallas kernel: the JAX package's eval BatchNorm is flax's, fused by XLA.
The plain version is the chain ``nn.layers.BatchNorm`` computes in eval
mode, then the call site's residual add and activation, one PyTorch kernel
a step; the kernel reads each element once and writes it once, with the
same bits. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel, which takes a 4-D ``channels_last``- or NCHW-contiguous float32,
bfloat16 or float16 map, a residual of its shape, type and layout, and
float32 ``mean`` / ``mul`` / ``bias`` [C], and raises on any other. Where
autograd records the call, :class:`BatchNormActFn` launches the kernel
forward and differentiates the plain chain backward.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import check, library

launches = 0  # kernel launches since the last reset
ACTS = {None: 0, 'relu': 1, 'silu': 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def epilogue(y: torch.Tensor, residual: Optional[torch.Tensor] = None,
             act: Optional[str] = None) -> torch.Tensor:
    """What follows the BatchNorm at its call site: ``y + residual``, then
    relu or silu."""
    if act not in ACTS:
        raise ValueError(f'batch_norm_act: act must be one of {list(ACTS)}, '
                         f'got {act!r}')
    if residual is not None:
        y = y + residual
    if act == 'relu':
        y = torch.relu(y)
    elif act == 'silu':
        y = F.silu(y)
    return y


def batch_norm_act_plain(x: torch.Tensor, mean: torch.Tensor,
                         mul: torch.Tensor, bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         act: Optional[str] = None) -> torch.Tensor:
    """``(x - mean) * mul + bias`` over the channels of an NCHW ``x`` in
    float32 (or x's type where that is wider), cast back to x's type, then
    :func:`epilogue`."""
    shape = (1, -1, 1, 1)
    f = x.to(torch.promote_types(x.dtype, torch.float32))
    y = (f - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return epilogue(y.to(x.dtype), residual, act)


def _check_vector(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if (t.shape != (x.shape[1],) or t.dtype != torch.float32
            or t.device != x.device or not t.is_contiguous()):
        raise ValueError(f'batch_norm_act: {name} must be [{x.shape[1]}] '
                         f'float32 on {x.device}; got {tuple(t.shape)} '
                         f'{t.dtype} on {t.device}')


def _launch(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
            bias: torch.Tensor, residual: Optional[torch.Tensor],
            act: Optional[str]) -> torch.Tensor:
    global launches
    if act not in ACTS:
        raise ValueError(f'batch_norm_act: act must be one of {list(ACTS)}, '
                         f'got {act!r}')
    cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
    fmt = torch.channels_last if cl else torch.contiguous_format
    if (x.dim() != 4 or x.dtype not in DTYPES
            or not x.is_contiguous(memory_format=fmt)):
        raise ValueError(
            'batch_norm_act: the kernel takes a 4-D channels_last- or '
            'NCHW-contiguous float32, bfloat16 or float16 map; got '
            f'{tuple(x.shape)} {x.dtype} strides {x.stride()}')
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=fmt)):
        raise ValueError(
            'batch_norm_act: the residual must have the map\'s shape, type, '
            f'device and layout; got {tuple(residual.shape)} '
            f'{residual.dtype} strides {residual.stride()}')
    for name, t in (('mean', mean), ('mul', mul), ('bias', bias)):
        _check_vector(name, t, x)
    y = torch.empty_like(x, memory_format=fmt)
    if x.numel() == 0:
        return y
    lib = library()
    dev = x.device
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        status = lib.mlk_batch_norm_act(
            x.data_ptr(), 0 if residual is None else residual.data_ptr(),
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel(), x.shape[1], 0 if cl else x.shape[2] * x.shape[3],
            DTYPES[x.dtype], ACTS[act],
            torch.cuda.current_stream(dev).cuda_stream)
    check(status, 'batch_norm_act')
    launches += 1
    return y


class BatchNormActFn(torch.autograd.Function):
    """K5 where autograd records the call (an eval-mode BatchNorm under
    gradients): the forward launches the kernel, the backward recomputes
    the plain chain from the saved inputs and differentiates it, so every
    gradient is the plain chain's, bit for bit."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias, residual, act):
        ctx.act = act
        ctx.save_for_backward(x, mean, mul, bias, residual)
        return _launch(x, mean, mul, bias, residual, act)

    @staticmethod
    def backward(ctx, dy):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = batch_norm_act_plain(*inputs, ctx.act)
        grads = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None,)


def batch_norm_act(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                   bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """:func:`batch_norm_act_plain`'s result in one kernel launch on the
    current stream (through :class:`BatchNormActFn` where autograd records
    the call); CPU tensors take :func:`batch_norm_act_plain`, a CUDA call
    the kernel cannot take raises."""
    dev = x.device
    if dev.type == 'cpu':
        return batch_norm_act_plain(x, mean, mul, bias, residual, act)
    if dev.type != 'cuda':
        raise ValueError(f'batch_norm_act: unsupported device {dev}')
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, mean, mul, bias, residual)):
        return BatchNormActFn.apply(x, mean, mul, bias, residual, act)
    return _launch(x, mean, mul, bias, residual, act)
