"""Collectives across the ranks of a data-parallel or spatial step.

Under the JAX package's mesh the train step sees the global batch, so its
train-mode BatchNorm, the box loss's moving statistics and the per-sample
drop-connect draws are those of the global batch. Here each rank of a
``torch.distributed`` group holds its rows of it (every rank the same
count), and these reductions become explicit:

  * ``all_reduce_sum``: a sum over the ranks whose gradient is the sum of
    the ranks' gradients (SyncBatchNorm's scheme), so a statistic of the
    global batch is differentiated as the one-process step differentiates
    it;
  * ``synchronized(model, ranks)``: within the block, the modules of
    ``model`` that carry a ``sync`` attribute (``BatchNorm``,
    efficientnet's blocks) reduce over ``ranks``; the block must hold the
    forward and the backward (a checkpointed backbone recomputes its
    forward in the backward).

The spatial (dp x sp) step (``nn.spatial``) splits a frame's rows over the
ranks of a model axis and adds two collectives, each differentiable with
its adjoint as gradient:

  * ``exchange_rows``: each rank gets rows ``[lo, hi)`` of a map whose
    rows the ranks hold in blocks, from the ranks that own them (the
    neighbours for a convolution's halo; farther ranks only when the
    window reaches past them); the gradient of a borrowed row goes back to
    its owner, which adds it;
  * ``gather_rows``: every rank gets the whole map (an all-gather); the
    gradient is the sum of the ranks' gradients, each rank keeping its
    block's (a reduce-scatter).

Every collective is a ``collective:*`` span for the profiler (the host's
time in it, its wait included): ``all_reduce``, ``row_exchange``,
``row_gather``.

A CUDA tensor reduced over a gloo group (ranks that share a card, where
NCCL refuses two ranks on one device) goes through gloo's own CUDA path,
which stages it through the host; gloo has no point-to-point transfer of
CUDA tensors, so the row exchanges stage their rows through the host
explicitly.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils import profiling


class Ranks(NamedTuple):
    """A data-parallel group (None: the default group), this process's rank
    in it and its size."""
    group: object
    rank: int
    world: int


def ranks_of(group=None) -> Ranks:
    return Ranks(group, dist.get_rank(group), dist.get_world_size(group))


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; every rank gets the same bits.
    Each call is a ``collective:all_reduce`` span (``utils.profiling``:
    the host's time in the reduction, its wait included)."""
    with profiling.span('collective:all_reduce'):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: the gradient that
    reaches each rank's ``t`` is the sum of every rank's gradient of the
    result."""
    return _AllReduceSum.apply(t, group)


def global_rank(ranks: Ranks, r: int) -> int:
    """Rank ``r`` of the group as a rank of the default group."""
    return r if ranks.group is None else dist.get_global_rank(ranks.group, r)


def _swap(ranks: Ranks, sends, recvs, like: torch.Tensor) -> List:
    """Point-to-point transfers within ``ranks``' group: ``sends`` [(peer,
    tensor)], ``recvs`` [(peer, shape)] of ``like``'s dtype -> the received
    tensors on ``like``'s device. A gloo group's CUDA tensors cross through
    host copies."""
    host = like.is_cuda and dist.get_backend(ranks.group) == 'gloo'
    where = torch.device('cpu') if host else like.device
    ops, got = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, t.to(where).contiguous(),
                              global_rank(ranks, peer), ranks.group))
    for peer, shape in recvs:
        got.append(torch.empty(shape, dtype=like.dtype, device=where))
        ops.append(dist.P2POp(dist.irecv, got[-1], global_rank(ranks, peer),
                              ranks.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [t.to(like.device) for t in got]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]):
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else None


def _like_format(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 4 and like.is_contiguous(
            memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _shape(x: torch.Tensor, dim: int, n: int) -> list:
    shape = list(x.shape)
    shape[dim] = n
    return shape


def _exchange(x, ranks, parts, windows, dim):
    me = ranks.rank
    own, want = parts[me], windows[me]
    sends = []
    for peer, window in enumerate(windows):
        ov = _overlap(own, window) if peer != me else None
        if ov:
            sends.append((peer, x.narrow(dim, ov[0] - own[0],
                                         ov[1] - ov[0])))
    recvs = []
    for peer, part in enumerate(parts):
        ov = _overlap(part, want) if peer != me else None
        if ov:
            recvs.append((peer, _shape(x, dim, ov[1] - ov[0])))
    got = iter(_swap(ranks, sends, recvs, x))
    pieces = []
    for peer, part in enumerate(parts):
        ov = _overlap(part, want)
        if ov and peer == me:
            pieces.append(x.narrow(dim, ov[0] - own[0], ov[1] - ov[0]))
        elif ov:
            pieces.append(next(got))
    if not pieces:
        return x.new_empty(_shape(x, dim, 0))
    return _like_format(torch.cat(pieces, dim), x)


def _return_rows(g, grad, ranks, parts, windows, dim):
    """The adjoint of ``_exchange``: the gradient of this rank's block, its
    own rows' share of ``g`` plus what the ranks that borrowed its rows send
    back, added into ``grad`` (zeros of the block's shape)."""
    me = ranks.rank
    own, want = parts[me], windows[me]
    sends = []
    for peer, part in enumerate(parts):
        ov = _overlap(part, want)
        if ov and peer == me:
            grad.narrow(dim, ov[0] - own[0], ov[1] - ov[0]).add_(
                g.narrow(dim, ov[0] - want[0], ov[1] - ov[0]))
        elif ov:
            sends.append((peer, g.narrow(dim, ov[0] - want[0],
                                         ov[1] - ov[0])))
    recvs, slots = [], []
    for peer, window in enumerate(windows):
        ov = _overlap(own, window) if peer != me else None
        if ov:
            recvs.append((peer, _shape(grad, dim, ov[1] - ov[0])))
            slots.append(ov)
    for ov, piece in zip(slots, _swap(ranks, sends, recvs, g)):
        grad.narrow(dim, ov[0] - own[0], ov[1] - ov[0]).add_(piece)
    return grad


class _RowExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, parts, windows, dim, span):
        ctx.meta = (ranks, parts, windows, dim, span)
        ctx.shape = x.shape
        ctx.channels_last = x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last)
        with profiling.span(span):
            return _exchange(x, ranks, parts, windows, dim)

    @staticmethod
    def backward(ctx, g):
        ranks, parts, windows, dim, span = ctx.meta
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        if ctx.channels_last:
            grad = grad.contiguous(memory_format=torch.channels_last)
        with profiling.span(span):
            grad = _return_rows(g, grad, ranks, parts, windows, dim)
        return grad, None, None, None, None, None


def exchange_rows(x: torch.Tensor, ranks: Ranks,
                  parts: Sequence[Tuple[int, int]],
                  windows: Sequence[Tuple[int, int]],
                  dim: int = -2) -> torch.Tensor:
    """Rows ``windows[rank]`` of a map split over the group's ranks along
    ``dim``, rank r holding rows ``parts[r]`` (contiguous blocks in rank
    order) as ``x``: each rank sends the rows of its block that another
    rank's window holds, to that rank only. Every rank of the group calls
    it with the same ``parts`` and ``windows`` (each within the map). The
    gradient of each row goes back to its owner."""
    return _RowExchange.apply(x, ranks, tuple(parts), tuple(windows),
                              dim % x.dim(), 'collective:row_exchange')


def gather_rows(x: torch.Tensor, ranks: Ranks,
                parts: Sequence[Tuple[int, int]],
                dim: int = -2) -> torch.Tensor:
    """The whole map on every rank (``exchange_rows`` with every window the
    whole map): an all-gather whose gradient is a reduce-scatter sum."""
    rows = parts[-1][1]
    return _RowExchange.apply(x, ranks, tuple(parts),
                              ((0, rows),) * len(parts), dim % x.dim(),
                              'collective:row_gather')


@contextlib.contextmanager
def synchronized(model: nn.Module, ranks: Ranks):
    """Within the block, every module of ``model`` with a ``sync``
    attribute reduces its batch statistics over ``ranks``."""
    modules = [m for m in model.modules() if hasattr(m, 'sync')]
    for m in modules:
        m.sync = ranks
    try:
        yield
    finally:
        for m in modules:
            m.sync = None
