"""Batch statistics across the ranks of a data-parallel step.

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

A CUDA tensor reduced over a gloo group (ranks that share a card, where
NCCL refuses two ranks on one device) goes through gloo's own CUDA path,
which stages it through the host.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function


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
    Each call is a ``collective:all_reduce`` span for the profiler (the
    host's time in the reduction, its wait included)."""
    with record_function('collective:all_reduce'):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: the gradient that
    reaches each rank's ``t`` is the sum of every rank's gradient of the
    result."""
    return _AllReduceSum.apply(t, group)


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
