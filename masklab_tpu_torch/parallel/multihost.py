"""Multi-process (multi-host) data-parallel training.

The port of ``masklab_tpu/parallel/multihost.py``. Each process owns one
device and is one rank of a ``torch.distributed`` group (``initialize``:
a TCP rendezvous at rank 0's address; NCCL where every rank owns a card,
gloo otherwise); every rank passes only its own local batch, and the
parallel train step (``mesh.make_parallel_train_step``) runs over the
group as the one-process step on the global batch.

This module is both a library (``initialize``, ``global_batch``,
``replicate_state``, ``run_one_step``) and a worker entry point::

    python -m masklab_tpu_torch.parallel.multihost \\
        --coordinator=localhost:9876 --num_processes=2 --process_id=0 \\
        [--shape=small|road] [--device=cpu|cuda]

which checks the NMS candidate pool (``check_nms_pool``), runs ONE
production train step over the group and prints
``MULTIHOST_OK process=r/N devices=N loss=...``; the loss is the same bits
on every rank (the gradient all-reduce crossed the process boundary). The
worker runs on the card unless ``--device=cpu`` (JAX's ``--local_devices``
of virtual CPU devices has no counterpart: one device a rank).
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import initialize, make_parallel_train_step, rank, replicate_state

__all__ = ['initialize', 'global_batch', 'replicate_state', 'run_one_step',
           'worker_config', 'setup_step', 'check_nms_pool']


def global_batch(batch: Dict, device, group=None) -> Dict[str, torch.Tensor]:
    """This process's local batch (numpy arrays) as the rank's part of the
    global batch: tensors on ``device``. Every rank must pass as many rows
    (the parallel step's global batch is their concatenation in rank
    order); raises otherwise."""
    from ..train.steps import as_batch
    rows = len(next(iter(batch.values())))
    extent = torch.tensor([rows, -rows], device=device)
    dist.all_reduce(extent, op=dist.ReduceOp.MAX, group=group)
    if extent.tolist() != [rows, -rows]:
        raise ValueError(f'local batches of {-int(extent[1])} to '
                         f'{int(extent[0])} rows: every rank must pass as '
                         'many')
    return as_batch(batch, device)


def worker_config(shape: str):
    """'small' = a narrow mobilenet; 'road' = the production road-preset
    architecture (seresnet34 + SE heads, full feature widths) at reduced
    resolution -> (config, (h, w))."""
    from ..config import ModelConfiguration
    from ..presets import road_project_config
    if shape == 'road':
        cfg = road_project_config()
        # modest NMS pools keep the one-step proof short; the architecture
        # (widths, depths, backbone) stays production
        cfg.detection.nms_max_output_size = 8
        cfg.loss.nms_max_output_size = 8
        cfg.compute.nms_candidates_per_class = 16
        return cfg, (128, 128)
    cfg = ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.num_features = 64
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 64
        g.num_depth = 1
    cfg.semantic.num_aspp_features = 64
    cfg.detection.nms_max_output_size = 8
    cfg.loss.nms_max_output_size = 8
    cfg.compute.nms_candidates_per_class = 16
    return cfg, (128, 128)


def setup_step(cfg, hw: Tuple[int, int], batch_per_rank: int, device,
               with_metrics: bool = False):
    """Every rank builds the same seeded model (seed 0), takes rank 0's
    state (``replicate_state``) and its own local batch (seeded by its
    rank) -> (state, parallel train step, local batch on ``device``)."""
    from ..data.synthetic import make_random_batch
    from ..models.masklab import build_masklab
    from ..train import TrainState, cyclic_lr, rectified_adam
    model = build_masklab(cfg, device=device, seed=0)
    state = TrainState(model, rectified_adam(cyclic_lr(1e-4, 1e-3, 700)),
                       box_beta=cfg.loss.box_loss_beta)
    replicate_state(state)
    local = make_random_batch(
        batch_per_rank, hw, 3,
        num_det_classes=len(cfg.dataset.instance_labels),
        num_seg_classes=len(cfg.dataset.semantic_labels), seed=rank())
    step = make_parallel_train_step(model, with_metrics=with_metrics,
                                    seed=cfg.train.seed)
    return state, step, global_batch(local, device)


def run_one_step(shape: str = 'small', batch_per_rank: int = 1,
                 device=None) -> float:
    """One data-parallel train step over the group; returns the loss.
    Call after ``initialize``."""
    cfg, hw = worker_config(shape)
    state, step, batch = setup_step(cfg, hw, batch_per_rank, device)
    state, metrics = step(state, batch)
    loss = float(metrics['loss'])
    if not np.isfinite(loss):
        raise FloatingPointError(f'non-finite loss: {loss}')
    return loss


def check_nms_pool(device) -> None:
    """Each rank's NMS candidate pool at the 512 px bench anchor count comes
    from the segment top-k (K2; its plain version on the CPU) with no
    certificate fallback, and equals the exact top-k: the values
    ``torch.topk``'s, the indices those of the (value descending, index
    ascending) order. The scores are the rank's rows of one global array,
    rounded to two decimals (thousands of exact ties a row)."""
    from ..ops import nms
    b, c, n, k, floor = dist.get_world_size(), 6, 81840, 256, 0.05
    full = np.random.RandomState(7).rand(b, c, n).astype(np.float32).round(2)
    mine = full[rank():rank() + 1]
    before = nms.pool_fallbacks
    vals, idxs = nms.candidate_pool(torch.from_numpy(mine).to(device), k,
                                    floor, sort_below=0)
    if nms.pool_fallbacks != before:
        raise AssertionError('NMS pool: the certificate fell back to the '
                             'exact top-k')
    flat = mine.reshape(c, n)
    order = np.lexsort((np.broadcast_to(np.arange(n), flat.shape), -flat),
                       axis=-1)[:, :k]
    want = torch.topk(torch.from_numpy(flat), k, dim=-1).values
    if not torch.equal(vals.cpu().reshape(c, k), want):
        raise AssertionError('NMS pool: values differ from torch.topk')
    if not np.array_equal(idxs.cpu().reshape(c, k).numpy(), order):
        raise AssertionError('NMS pool: indices differ from the exact order')
    print(f'NMS_POOL_OK process={rank()} segment pool exact', flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('--coordinator', required=True)
    p.add_argument('--num_processes', type=int, required=True)
    p.add_argument('--process_id', type=int, required=True)
    p.add_argument('--shape', default='small', choices=('small', 'road'))
    p.add_argument('--device', default='cuda', choices=('cpu', 'cuda'))
    args = p.parse_args(argv)
    device = initialize(args.coordinator, args.num_processes,
                        args.process_id, device=args.device)
    try:
        check_nms_pool(device)
        loss = run_one_step(args.shape, device=device)
        print(f'MULTIHOST_OK process={rank()}/{dist.get_world_size()} '
              f'devices={dist.get_world_size()} loss={loss!r}', flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
