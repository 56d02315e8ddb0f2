"""Spatial sharding: a frame's rows over the ranks of a mesh's model axis.

The port of the JAX package's dp x sp layout
(``masklab_tpu/parallel/mesh.py:47-74``): a ('data', 'model') mesh where
each rank holds its data row's images and, of every 4-D map, a block of
the rows. There GSPMD inserts the halo exchanges and the height
contractions' sums; here each layer asks for them (``nn.sync``'s row
exchange, row gather and all-reduce):

  * ``blocks(rows, parts)``: the partition, the same at every level: rank m
    holds rows ``[m * rows // parts, (m + 1) * rows // parts)``, contiguous
    and balanced, possibly empty (a 1-row map over 2 ranks);
  * ``spatially_sharded(model, sp, dp)``: within the block the modules and
    functions below run sharded over ``sp`` (the rank's model-axis group),
    with the data axis ``dp`` for the per-image draws (``sync``, as
    ``nn.sync.synchronized`` arms it) and the whole mesh for train-mode
    BatchNorm; ``replicated()`` suspends it where the maps are whole on
    every rank (the mask heads' RoI crops);
  * each layer's output block is computed from the input window it needs:
    ``conv_rows`` (the halo of a k x k conv, its stride and dilation, zeros
    only at the frame's top and bottom), ``pool_rows`` (-inf or zero halos),
    ``subsample_rows``, ``resize_like`` (each rank's output rows of the TF1
    interpolation matrix on the input rows they touch), ``mean_hw`` /
    ``sum_hw`` (sums over the group), ``gather`` (the whole map; the heads'
    anchor rows and the ragged GroupNorm maps K1 takes whole).

A map's global row count is the sum of the ranks' block heights: each
layer (a "site": a module, or a key naming the call) learns it once per
frame height over a host-side gloo group and keeps it; a site that later
gets another height of map at that frame raises, naming itself.

The sharding in force is a context variable: it holds in the thread that
entered the block (whatever runs there in the block runs sharded), not in
other threads. The backward needs none of it (each collective keeps its
groups), except a checkpointed backbone's recomputation, which re-enters
the sharding its forward saw (``in_effect``): the autograd engine runs a
card's backward in threads of its own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.resize import _interp_matrix, resize_spatial, work_dtype
from ..utils.profiling import span
from .sync import Ranks, all_reduce_sum, exchange_rows, gather_rows, ranks_of


class SpatialRanks(NamedTuple):
    """A rank's groups on a (data, model) mesh: ``sp`` its model-axis group
    (the ranks sharing its images), ``dp`` its data-axis group, ``world``
    the mesh, ``host`` a gloo group of the ``sp`` ranks."""
    sp: Ranks
    dp: Ranks
    world: Ranks
    host: object


def blocks(rows: int, parts: int) -> List[Tuple[int, int]]:
    """Each rank's rows ``[start, stop)`` of a map of ``rows`` rows."""
    return [(m * rows // parts, (m + 1) * rows // parts)
            for m in range(parts)]


class Spatial:
    """The active sharding: ``sp`` (the rank's model-axis group), ``dp``
    (its data-axis group), ``world`` (the mesh), ``host`` (a gloo group of
    the ``sp`` ranks for row counts), ``cache`` ({(site, frame rows): map
    rows and this rank's}, kept with the model), ``names`` ({module: its
    name in the model}) and the frame's rows of this forward."""

    def __init__(self, sp: Ranks, dp: Ranks, world: Ranks, host, cache,
                 names=None):
        self.sp, self.dp, self.world, self.host = sp, dp, world, host
        self.cache, self.names = cache, names or {}
        self.image_rows = None

    def block(self, rows: int) -> Tuple[int, int]:
        return blocks(rows, self.sp.world)[self.sp.rank]

    def _total(self, n: int) -> int:
        if self.sp.world == 1:
            return n
        t = torch.tensor([n], dtype=torch.int64)
        with span('collective:rows'):
            dist.all_reduce(t, group=self.host)
        return int(t)

    def start(self, rows: int) -> int:
        """The frame's global rows from this rank's ``rows`` (every rank
        calls it once a forward of the backbone)."""
        self.image_rows = self._total(rows)
        return self.image_rows

    def rows(self, site, rows: int) -> int:
        """The global rows of the map ``site`` gets, from this rank's
        ``rows``: summed over the group the first time at this frame
        height, then kept. A site is one map a frame: another height of
        map there raises."""
        key = (site, self.image_rows)
        if key not in self.cache:
            self.cache[key] = (self._total(rows), rows)
        total, local = self.cache[key]
        if rows != local:
            raise ValueError(
                f'{self.name(site)}: a map of {rows} rows on rank '
                f'{self.sp.rank} where it had {local} at a frame of '
                f'{self.image_rows} rows: a sharded site takes one map '
                'height a frame')
        return total

    def name(self, site) -> str:
        """``site`` in words: a module by its name in the model."""
        if isinstance(site, tuple):
            return ' '.join(self.name(s) for s in site)
        if isinstance(site, nn.Module):
            return (f'{type(site).__name__} '
                    f'{self.names.get(site, "(outside the model)")}')
        return str(site)


_STATE: contextvars.ContextVar = contextvars.ContextVar(
    'masklab_spatial', default=None)


def active() -> Optional[Spatial]:
    """The sharding in force in this context: None outside
    ``spatially_sharded``, inside ``replicated`` and in another thread."""
    return _STATE.get()


@contextlib.contextmanager
def in_effect(state: Optional[Spatial]):
    """Within the block ``state`` is the sharding in force in this context
    (None: nothing is sharded)."""
    token = _STATE.set(state)
    try:
        yield state
    finally:
        _STATE.reset(token)


@contextlib.contextmanager
def spatially_sharded(model: nn.Module, sp: Ranks, dp: Ranks,
                      world: Optional[Ranks] = None, host=None):
    """Within the block, ``model`` runs on this rank's rows of each frame:
    ``sp`` is its model-axis group, ``dp`` its data-axis group (the modules
    with a ``sync`` attribute, efficientnet's drop-connect, draw for the
    data row), ``world`` the mesh (default: the default group; train-mode
    BatchNorm reduces over it), ``host`` a gloo group of the ``sp`` ranks
    (default: ``sp``'s group). The block must hold the forward and the
    backward (a checkpointed backbone recomputes its forward, exchanges
    included, in the backward; see the module's docstring on threads)."""
    if active() is not None:
        raise RuntimeError('spatially_sharded blocks do not nest')
    cache = model.__dict__.setdefault('_spatial_rows', {}).setdefault(
        (sp.world, sp.rank), {})
    names = {m: n for n, m in model.named_modules()}
    state = Spatial(sp, dp, world or ranks_of(None),
                    sp.group if host is None else host, cache, names)
    modules = [m for m in names if hasattr(m, 'sync')]
    for m in modules:
        m.sync = dp
    try:
        with in_effect(state):
            yield state
    finally:
        for m in modules:
            m.sync = None


def replicated():
    """Within the block the maps are whole on every rank (nothing is
    sharded)."""
    return in_effect(None)


def same_pads(n: int, kernel: int) -> Tuple[int, int]:
    """XLA 'SAME' padding of a k x k stride-2 conv on an axis of ``n``:
    ceil(n / 2) outputs, max((ceil(n / 2) - 1) * 2 + k - n, 0) zeros, the
    smaller half before."""
    total = max((-(-n // 2) - 1) * 2 + kernel - n, 0)
    return total // 2, total - total // 2


class RowPad(NamedTuple):
    """A stride-2 conv's input padded in width only, with the rows' padding
    (``'valid'``: Keras (0, 1); ``'same'``: XLA SAME of a ``kernel``) left
    to the conv, which knows the frame's parity: ``pad_valid_s2`` /
    ``pad_same_s2`` return it while sharded, for a ``layers.Conv2d`` to
    take straight away."""
    tensor: torch.Tensor
    mode: str
    kernel: int = 3

    def rows(self, n: int) -> Tuple[int, int]:
        return (0, 1) if self.mode == 'valid' else same_pads(n, self.kernel)


def _windows(sp: Spatial, rows_out: int, extent: int, stride: int,
             top: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Each rank's output block of ``rows_out`` and the input rows (before
    clipping to the map) a window of ``extent`` rows, ``stride`` and
    ``top`` rows of padding needs for it. An empty block computes one row
    it drops, so that every rank runs the same operations."""
    out = blocks(rows_out, sp.sp.world)
    wins = []
    for a, b in out:
        if b == a:
            a = min(a, rows_out - 1)
            b = a + 1
        wins.append((a * stride - top, (b - 1) * stride - top + extent))
    return out, wins


def fetch_window(sp: Spatial, x: torch.Tensor, rows: int,
                 windows: List[Tuple[int, int]], fill: float = 0.0
                 ) -> torch.Tensor:
    """This rank's rows ``windows[rank]`` of the NCHW map ``x`` (its block
    of ``rows``), the rows outside the map filled with ``fill``."""
    clipped = []
    for lo, hi in windows:
        lo_c, hi_c = max(lo, 0), min(hi, rows)
        clipped.append((lo_c, hi_c) if hi_c > lo_c else (0, 0))
    got = exchange_rows(x, sp.sp, blocks(rows, sp.sp.world), clipped, -2)
    lo, hi = windows[sp.sp.rank]
    top = max(0, min(hi, 0) - lo)
    bottom = max(0, hi - max(lo, rows))
    if top or bottom:
        got = F.pad(got, (0, 0, top, bottom), value=fill)
        if x.is_contiguous(memory_format=torch.channels_last):
            got = got.contiguous(memory_format=torch.channels_last)
    return got


def _keep(sp: Spatial, y: torch.Tensor, out) -> torch.Tensor:
    a, b = out[sp.sp.rank]
    return y if b > a else y[:, :, :0]


def conv_rows(sp: Spatial, site, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride, padding, dilation,
              groups: int, pad_mode: Optional[RowPad] = None
              ) -> torch.Tensor:
    """This rank's output rows of ``F.conv2d`` on the sharded NCHW map
    ``x``: its input window with the halo rows of the ranks around it,
    zero rows only beyond the frame's top and bottom (``padding``'s rows,
    or ``pad_mode``'s from the map's global parity), no row padding in the
    conv itself."""
    rows = sp.rows(site, x.shape[-2])
    kh, sh, dh = weight.shape[-2], stride[0], dilation[0]
    top, bottom = (pad_mode.rows(rows) if pad_mode is not None
                   else (padding[0], padding[0]))
    extent = dh * (kh - 1) + 1
    rows_out = (rows + top + bottom - extent) // sh + 1
    out, wins = _windows(sp, rows_out, extent, sh, top)
    y = F.conv2d(fetch_window(sp, x, rows, wins), weight, bias,
                 (sh, stride[1]), (0, padding[1]), (dh, dilation[1]), groups)
    return _keep(sp, y, out)


def pool_rows(sp: Spatial, site, x: torch.Tensor, kernel: int, stride: int,
              padding: int, fill: float) -> torch.Tensor:
    """This rank's output rows of a k x k max pool (``padding`` rows and
    columns of ``fill``, -inf or zeros) of the sharded NCHW map ``x``."""
    rows = sp.rows(site, x.shape[-2])
    rows_out = (rows + 2 * padding - kernel) // stride + 1
    out, wins = _windows(sp, rows_out, kernel, stride, padding)
    xw = fetch_window(sp, x, rows, wins, fill)
    if padding:
        xw = F.pad(xw, (padding, padding), value=fill)
    return _keep(sp, F.max_pool2d(xw, kernel, stride), out)


def subsample_rows(sp: Spatial, site, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """This rank's rows of ``x[:, :, ::stride, ::stride]``."""
    rows = sp.rows(site, x.shape[-2])
    out, wins = _windows(sp, -(-rows // stride), 1, stride, 0)
    y = fetch_window(sp, x, rows, wins)[:, :, ::stride, ::stride]
    return _keep(sp, y, out)


def empty_conv(conv, x: torch.Tensor) -> torch.Tensor:
    """A pointwise conv of an empty block: one zero row through the conv,
    dropped (every rank runs the same operations)."""
    return conv(F.pad(x, (0, 0, 0, 1)))[:, :, :0]


def resize_like(x: torch.Tensor, like: torch.Tensor, site,
                align_corners: bool = True,
                channels_last: bool = False) -> torch.Tensor:
    """``resize_spatial`` of ``x`` to ``like``'s size. Sharded (both maps
    hold this rank's rows): each rank applies its output rows of the
    height matrix to the input rows they touch (fetched from the ranks
    that hold them), then resizes the width."""
    ah, aw = (-3, -2) if channels_last else (-2, -1)
    sp = active()
    if sp is None:
        return resize_spatial(x, like.shape[ah], like.shape[aw],
                              align_corners, channels_last)
    rows_in = sp.rows((site, 'in'), x.shape[ah])
    rows_out = sp.rows((site, 'out'), like.shape[ah])
    if rows_in != rows_out:
        wh = _interp_matrix(rows_in, rows_out, align_corners)
        out = blocks(rows_out, sp.sp.world)
        wins = []
        for a, b in out:
            cols = np.nonzero(wh[a:b].any(0))[0]
            wins.append((int(cols[0]), int(cols[-1]) + 1) if len(cols)
                        else (0, 0))
        orig = x.dtype
        xw = exchange_rows(x, sp.sp, blocks(rows_in, sp.sp.world), wins,
                           ah).to(work_dtype(x.dtype))
        (a, b), (c0, c1) = out[sp.sp.rank], wins[sp.sp.rank]
        mat = torch.from_numpy(np.ascontiguousarray(wh[a:b, c0:c1])).to(
            xw.device, xw.dtype)
        x = torch.movedim(torch.tensordot(xw, mat, dims=([ah], [1])), -1, ah)
        x = x.to(orig) if orig.is_floating_point else x
    return resize_spatial(x, x.shape[ah], like.shape[aw], align_corners,
                          channels_last)


def sum_hw(x: torch.Tensor, dims=(-2, -1), keepdim: bool = False
           ) -> torch.Tensor:
    """The sum over the rows ``dims[0]`` and columns ``dims[1]``: over the
    group's blocks when sharded (differentiable)."""
    s = x.sum(dims, keepdim=keepdim)
    sp = active()
    return s if sp is None else all_reduce_sum(s, sp.sp.group)


def mean_hw(x: torch.Tensor, site, dims=(-2, -1),
            keepdim: bool = False) -> torch.Tensor:
    """The spatial mean over the rows ``dims[0]`` and columns ``dims[1]``;
    sharded, the group's float32 (or wider) sums over the map's global
    count, in x's dtype."""
    sp = active()
    if sp is None:
        return x.mean(dims, keepdim=keepdim)
    rows = sp.rows(site, x.shape[dims[0]])
    acc = torch.promote_types(x.dtype, torch.float32)
    s = all_reduce_sum(x.to(acc).sum(dims, keepdim=keepdim), sp.sp.group)
    return (s / (rows * x.shape[dims[1]])).to(x.dtype)


def gather(x: torch.Tensor, site, dim: int = -2) -> torch.Tensor:
    """The whole map on every rank of the group (the identity when not
    sharded)."""
    sp = active()
    if sp is None:
        return x
    rows = sp.rows(site, x.shape[dim])
    return gather_rows(x, sp.sp, blocks(rows, sp.sp.world), dim)


def frame_rows(rows: int) -> int:
    """The frame's global rows from this rank's (the frame read by the
    backbone of this forward, when sharded)."""
    sp = active()
    return rows if sp is None else sp.image_rows


def crop_rows(site, fmap_rows: int) -> Optional[Tuple[int, int, int]]:
    """(global rows, start, stop) of this rank's block of a sharded map of
    ``fmap_rows`` local rows, for the RoI crops' height contraction; None
    when not sharded."""
    sp = active()
    if sp is None:
        return None
    rows = sp.rows(site, fmap_rows) if site is not None else sp.image_rows
    return (rows, *sp.block(rows))


def reduce_crops(crops: torch.Tensor) -> torch.Tensor:
    """The sum over the group of each rank's share of RoI crops (float32 or
    wider), in the crops' dtype: the crops whole on every rank."""
    sp = active()
    if sp is None:
        return crops
    acc = torch.promote_types(crops.dtype, torch.float32)
    return all_reduce_sum(crops.to(acc), sp.sp.group).to(crops.dtype)


__all__ = ['SpatialRanks', 'blocks', 'Spatial', 'active', 'in_effect',
           'spatially_sharded', 'replicated', 'same_pads', 'RowPad',
           'fetch_window',
           'conv_rows', 'pool_rows', 'subsample_rows', 'empty_conv',
           'resize_like', 'sum_hw', 'mean_hw', 'gather', 'frame_rows',
           'crop_rows', 'reduce_crops']
