"""Data and spatial parallelism over ``torch.distributed``.

The port of ``masklab_tpu/parallel/mesh.py``. There a ``jax.sharding.Mesh``
with a ``data`` axis shards the batch, GSPMD sees the global batch and
inserts the reductions. Here each rank of a process group runs the port's
train step on its rows of the global batch, and the reductions that GSPMD
gives for free are explicit (``nn.sync``, ``train.steps``): train-mode
BatchNorm, the box loss's moving statistics and the drop-connect draws of
the global batch, the gradients, loss and metrics averaged over the ranks.
The result is the one-process step on the global batch.

  * ``Mesh`` / ``make_mesh``: a ('data', 'model') mesh of devices, rank
    ``d * model + m`` at (d, m), as the JAX package reshapes its devices;
    the predictor keeps one model replica on each device of a ``data``
    mesh; in a train step a mesh stands for the process group, whose size
    it must have;
  * ``initialize``: joins a process group from a rendezvous address. The
    backend follows the placement: NCCL where each rank owns a card, gloo
    for CPU ranks and for ranks that share a card (NCCL refuses two ranks
    on one device);
  * ``world``, ``rank``, ``shard_batch`` (this rank's rows of a global
    batch), ``replicate_state`` (rank 0's parameters, statistics and box
    state on every rank);
  * ``make_parallel_train_step`` / ``make_parallel_eval_step``;
  * the dp x sp spatial sharding (a ``model`` axis above 1):
    ``spatial_batch_sharding`` (the JAX package's leaf-to-axes map: images
    and gt_seg [B, H, W, C] by batch over 'data' and height over 'model',
    gt_masks [B, G, H, W] likewise, boxes and flags by batch),
    ``spatial_shard_batch`` (this rank's piece), ``spatial_ranks`` (the
    rank's groups of the mesh), ``sharded`` (a block in which a model's
    forward runs on this rank's piece) and the steps' ``batch_shardings=``.
    GSPMD's halo exchanges and height contractions are ``nn.spatial``'s.

The loss NMS stays per image on each rank (the JAX package's
``shard_local_nms`` is a TPU form with nothing to port); in the spatial
step every rank of a data row runs it on the row's gathered heads.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..nn.spatial import SpatialRanks, blocks, spatially_sharded
from ..nn.sync import Ranks, ranks_of
from ..train.state import TrainState
from ..train.steps import make_eval_step, make_train_step


@dataclass(frozen=True)
class Mesh:
    """The mesh's devices in rank order (rank ``d * model + m`` at data
    index d, model index m) and its ``model`` axis."""
    devices: Tuple[torch.device, ...]
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {'data': len(self.devices) // self.model, 'model': self.model}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over the first ``data * model`` of
    ``devices`` (default: every card present; a device may appear more
    than once, as ``['cuda:0', 'cuda:0']``). ``data`` defaults to as many as
    the devices allow."""
    if model < 1:
        raise ValueError(f'a model axis of {model}')
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA card; pass devices= '
                               "(e.g. ['cpu', 'cpu'])")
        devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    data = len(devices) // model if data is None else data
    if not 1 <= data * model <= len(devices):
        raise ValueError(f'a mesh of {data} x {model} over {len(devices)} '
                         'device(s)')
    return Mesh(tuple(devices[:data * model]), model)


def _placement(device: torch.device) -> str:
    """What two ranks share when they share a device."""
    if device.type != 'cuda':
        return f'{socket.gethostname()}/cpu'
    uuid = torch.cuda.get_device_properties(device).uuid
    return f'{socket.gethostname()}/{uuid}'


def initialize(coordinator: str, num_processes: int, process_id: int,
               device=None, timeout_s: float = 600.0) -> torch.device:
    """Join the default process group of ``num_processes`` ranks through a
    TCP rendezvous at ``coordinator`` ('host:port', served by rank 0), as
    ``process_id``, on ``device`` (the card by default; a bare 'cuda' is
    card ``process_id`` modulo the cards present). The ranks first tell
    each other their devices: NCCL when no two share one and they are
    cards, gloo otherwise. Prints the choice; returns the device."""
    device = resolve_device(device)
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device(
                'cuda', process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    host, port = coordinator.rsplit(':', 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=timedelta(seconds=timeout_s))
    store.set(f'placement/{process_id}', _placement(device))
    places = [store.get(f'placement/{r}').decode()
              for r in range(num_processes)]
    backend = ('nccl' if device.type == 'cuda'
               and len(set(places)) == num_processes else 'gloo')
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=timedelta(seconds=timeout_s))
    print(f'process group: rank {process_id} of {num_processes} on '
          f'{device}, backend {backend}', flush=True)
    return device


def world(group=None) -> int:
    """The group's size; 1 outside a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 outside a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def data_ranks(mesh_or_group=None) -> Ranks:
    """The ``nn.sync.Ranks`` of a train step's group: a process group (None:
    the default one), its ``Ranks``, or a ``Mesh`` standing for the default
    group, whose size it must have."""
    if isinstance(mesh_or_group, Ranks):
        return mesh_or_group
    if isinstance(mesh_or_group, Mesh):
        ranks = ranks_of(None)
        if mesh_or_group.size != ranks.world:
            raise ValueError(f'a mesh of {mesh_or_group.size} over a '
                             f'process group of {ranks.world}')
        return ranks
    return ranks_of(mesh_or_group)


def _rows_of(batch: Dict, part: int, parts: int) -> Dict:
    size = len(next(iter(batch.values())))
    if size % parts:
        raise ValueError(f'a batch of {size} does not divide over '
                         f'{parts} ranks')
    rows = size // parts
    return {k: v[part * rows:(part + 1) * rows] for k, v in batch.items()}


def shard_batch(batch: Dict, mesh_or_group=None) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    batch in ``world`` equal parts, part ``rank``; on a mesh with a model
    axis, the rows of the rank's data index (the ranks of a data row hold
    the same images)."""
    ranks = data_ranks(mesh_or_group)
    if isinstance(mesh_or_group, Mesh) and mesh_or_group.model > 1:
        data, model = mesh_or_group.shape['data'], mesh_or_group.model
        return _rows_of(batch, ranks.rank // model, data)
    return _rows_of(batch, ranks.rank, ranks.world)


# the leaves the dp x sp layout splits by height, and their height axis
_HEIGHT_AXIS = {'images': 1, 'gt_seg': 1, 'gt_masks': 2}


def spatial_batch_sharding(batch: Dict, mesh: Mesh) -> Dict:
    """The dp x sp layout of a batch, the JAX package's leaf-to-axes map:
    images and gt_seg [B, H, W, C] ('data', 'model'), gt_masks [B, G, H, W]
    ('data', None, 'model'), every other leaf (boxes, flags) ('data',)."""
    out = {}
    for k in batch:
        axis = _HEIGHT_AXIS.get(k)
        out[k] = (('data',) if axis is None
                  else ('data',) + (None,) * (axis - 1) + ('model',))
    return out


def spatial_shard_batch(batch: Dict, mesh: Mesh,
                        rank: Optional[int] = None) -> Dict:
    """This rank's piece of a global batch under
    ``spatial_batch_sharding``: the rows of its data index, and of each
    height-split leaf the block of rows of its model index
    (``nn.spatial.blocks``). ``rank``: of the default group unless
    given."""
    data, model = mesh.shape['data'], mesh.model
    r = (dist.get_rank() if dist.is_initialized() else 0) \
        if rank is None else rank
    d, m = divmod(r, model)
    out = _rows_of(batch, d, data)
    for k, axes in spatial_batch_sharding(batch, mesh).items():
        if 'model' in axes:
            axis = axes.index('model')
            a, b = blocks(out[k].shape[axis], model)[m]
            out[k] = out[k][(slice(None),) * axis + (slice(a, b),)]
    return out


_SPATIAL_RANKS = {}


def spatial_ranks(mesh: Mesh) -> SpatialRanks:
    """This rank's groups of ``mesh`` over the default group (whose size
    it must have): the model-axis group of its data row, the data-axis
    group of its model index, the mesh, and a gloo group of its data row
    for row counts. Every rank calls ``dist.new_group`` for every group in
    the same order; the groups are made once a process group."""
    data, model = mesh.shape['data'], mesh.model
    world = data_ranks(mesh)
    key = (data, model, id(dist.group.WORLD))
    if key in _SPATIAL_RANKS:
        return _SPATIAL_RANKS[key]
    d, m = divmod(world.rank, model)
    gloo = dist.get_backend() == 'gloo'
    sp = dp = host = None
    for row in range(data):
        members = [row * model + j for j in range(model)]
        group = dist.new_group(members)
        gloo_group = group if gloo else dist.new_group(members,
                                                       backend='gloo')
        if row == d:
            sp, host = Ranks(group, m, model), gloo_group
    for col in range(model):
        group = dist.new_group([i * model + col for i in range(data)])
        if col == m:
            dp = Ranks(group, d, data)
    if not gloo:
        # NCCL: every rank of a group joins its first call
        for ranks in (sp, dp):
            dist.all_reduce(torch.zeros(1, device='cuda'), group=ranks.group)
    _SPATIAL_RANKS[key] = out = SpatialRanks(sp, dp, world, host)
    return out


def sharded(model, mesh: Mesh):
    """A block in which ``model`` runs on this rank's piece of each frame
    (``spatial_shard_batch``): ``nn.spatial.spatially_sharded`` over the
    rank's groups of ``mesh``. The heads' outputs come back whole,
    ``seg_pred`` as this rank's rows."""
    return spatially_sharded(model, *spatial_ranks(mesh))


def _spatial_layout(batch_shardings, mesh_or_group) -> Optional[Mesh]:
    """The mesh of a dp x sp step, or None for a data-parallel one; a model
    axis without the spatial layout, or a layout no step runs, raises."""
    model = (mesh_or_group.model if isinstance(mesh_or_group, Mesh) else 1)
    if batch_shardings is None:
        if model > 1:
            raise ValueError(
                f'a model axis of {model}: pass batch_shardings='
                'spatial_batch_sharding(batch, mesh)')
        return None
    for k, axes in batch_shardings.items():
        axis = _HEIGHT_AXIS.get(k)
        allowed = [('data',)]
        if axis is not None:
            allowed.append(('data',) + (None,) * (axis - 1) + ('model',))
        if tuple(axes) not in allowed:
            raise ValueError(f'batch_shardings[{k!r}] = {axes}: the steps '
                             'run the batch over data and the dp x sp '
                             'layout (spatial_batch_sharding)')
    if not any('model' in axes for axes in batch_shardings.values()):
        if model > 1:
            raise ValueError(f'a model axis of {model} with no leaf split '
                             'by height')
        return None
    if not isinstance(mesh_or_group, Mesh):
        raise ValueError('the dp x sp layout needs the Mesh')
    return mesh_or_group


def replicate_state(state: TrainState,
                    mesh_or_group=None) -> TrainState:
    """Rank 0's parameters, BatchNorm statistics and box state on every
    rank, in place (the optimizer state, built from the parameters, is the
    same on every rank then)."""
    group = data_ranks(mesh_or_group).group
    tensors = [*state.params.values(), *state.batch_stats.values(),
               *state.box_loss_state]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=dist.get_global_rank(group, 0)
                           if group is not None else 0, group=group)
    return state


def make_parallel_train_step(model, mesh_or_group=None,
                             with_metrics: bool = True, seed: int = 42,
                             batch_shardings=None) -> Callable:
    """(state, this rank's rows) -> (state, metrics): the one-process train
    step on the global batch (``train.steps``), every rank's update the
    same. ``batch_shardings`` (``spatial_batch_sharding`` over a mesh with
    a model axis): the dp x sp step on this rank's piece
    (``spatial_shard_batch``)."""
    mesh = _spatial_layout(batch_shardings, mesh_or_group)
    if mesh is not None:
        return make_train_step(model, with_metrics, seed,
                               spatial=spatial_ranks(mesh))
    return make_train_step(model, with_metrics, seed,
                           ranks=data_ranks(mesh_or_group))


def make_parallel_eval_step(model, mesh_or_group=None,
                            with_metrics: bool = True,
                            batch_shardings=None) -> Callable:
    """(state, this rank's rows) -> metrics of the global batch: the running
    BatchNorm statistics (no reduction), the box loss's batch statistics
    and the metrics over the ranks. ``batch_shardings``: as
    ``make_parallel_train_step``."""
    mesh = _spatial_layout(batch_shardings, mesh_or_group)
    if mesh is not None:
        return make_eval_step(model, with_metrics,
                              spatial=spatial_ranks(mesh))
    return make_eval_step(model, with_metrics,
                          ranks=data_ranks(mesh_or_group))


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous of local ranks."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


__all__ = ['Mesh', 'make_mesh', 'initialize', 'world', 'rank', 'data_ranks',
           'shard_batch', 'replicate_state', 'spatial_batch_sharding',
           'spatial_shard_batch', 'spatial_ranks', 'sharded',
           'make_parallel_train_step', 'make_parallel_eval_step',
           'free_port']
