"""Data parallelism over ``torch.distributed``.

The port of ``masklab_tpu/parallel/mesh.py``. There a ``jax.sharding.Mesh``
with a ``data`` axis shards the batch, GSPMD sees the global batch and
inserts the reductions. Here each rank of a process group runs the port's
train step on its rows of the global batch, and the reductions that GSPMD
gives for free are explicit (``nn.sync``, ``train.steps``): train-mode
BatchNorm, the box loss's moving statistics and the drop-connect draws of
the global batch, the gradients, loss and metrics averaged over the ranks.
The result is the one-process step on the global batch.

  * ``Mesh`` / ``make_mesh``: the devices of the ``data`` axis in this
    process (the predictor keeps one model replica on each); in a train
    step a mesh stands for the process group, whose size it must have;
  * ``initialize``: joins a process group from a rendezvous address. The
    backend follows the placement: NCCL where each rank owns a card, gloo
    for CPU ranks and for ranks that share a card (NCCL refuses two ranks
    on one device);
  * ``world``, ``rank``, ``shard_batch`` (this rank's rows of a global
    batch), ``replicate_state`` (rank 0's parameters, statistics and box
    state on every rank);
  * ``make_parallel_train_step`` / ``make_parallel_eval_step``.

The loss NMS stays per image on each rank (the JAX package's
``shard_local_nms`` is a TPU form with nothing to port). The dp x sp
spatial sharding (``spatial_batch_sharding``, a ``model`` axis above 1) is
not ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..nn.sync import Ranks, ranks_of
from ..train.state import TrainState
from ..train.steps import make_eval_step, make_train_step


@dataclass(frozen=True)
class Mesh:
    """The devices of the ``data`` axis, in order."""
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {'data': len(self.devices), 'model': 1}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over the first ``data`` of ``devices``
    (default: every card present; a device may appear more than once, as
    ``['cuda:0', 'cuda:0']``). ``data`` defaults to all of them."""
    if model != 1:
        raise NotImplementedError(
            f'a model axis of {model}: the dp x sp spatial sharding is not '
            'ported to PyTorch yet (ROADMAP.md, Queue 1)')
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA card; pass devices= '
                               "(e.g. ['cpu', 'cpu'])")
        devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    data = len(devices) if data is None else data
    if not 1 <= data <= len(devices):
        raise ValueError(f'a data axis of {data} over {len(devices)} '
                         'device(s)')
    return Mesh(tuple(devices[:data]))


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
    group, whose size its data axis must have."""
    if isinstance(mesh_or_group, Ranks):
        return mesh_or_group
    if isinstance(mesh_or_group, Mesh):
        ranks = ranks_of(None)
        if mesh_or_group.size != ranks.world:
            raise ValueError(f'a mesh of {mesh_or_group.size} over a '
                             f'process group of {ranks.world}')
        return ranks
    return ranks_of(mesh_or_group)


def shard_batch(batch: Dict, mesh_or_group=None) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    batch in ``world`` equal parts, part ``rank``."""
    ranks = data_ranks(mesh_or_group)
    size = len(next(iter(batch.values())))
    if size % ranks.world:
        raise ValueError(f'a batch of {size} does not divide over '
                         f'{ranks.world} ranks')
    rows = size // ranks.world
    return {k: v[ranks.rank * rows:(ranks.rank + 1) * rows]
            for k, v in batch.items()}


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
                             with_metrics: bool = True,
                             seed: int = 42) -> Callable:
    """(state, this rank's rows) -> (state, metrics): the one-process train
    step on the global batch (``train.steps``), every rank's update the
    same."""
    return make_train_step(model, with_metrics, seed,
                           ranks=data_ranks(mesh_or_group))


def make_parallel_eval_step(model, mesh_or_group=None,
                            with_metrics: bool = True) -> Callable:
    """(state, this rank's rows) -> metrics of the global batch: the running
    BatchNorm statistics (no reduction), the box loss's batch statistics
    and the metrics over the ranks."""
    return make_eval_step(model, with_metrics,
                          ranks=data_ranks(mesh_or_group))


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous of local ranks."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


__all__ = ['Mesh', 'make_mesh', 'initialize', 'world', 'rank', 'data_ranks',
           'shard_batch', 'replicate_state', 'make_parallel_train_step',
           'make_parallel_eval_step', 'free_port']
