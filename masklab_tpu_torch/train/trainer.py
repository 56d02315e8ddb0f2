"""The canonical training entry: 3-phase progressive unfreezing.

The port's counterpart of ``masklab_tpu/train/trainer.py``:
  * datasets from the ETL's seed-777 split (``construct_masklab_datasets``);
    the valid batch is 4x the train batch, clamped;
  * smoke check: one tiny-LR step at the largest scale bucket proves the
    graph trains and memory fits before real training;
  * three phases (head-tune: freeze <= C5, waist-tune: freeze <= C2,
    all-tune), each with a new RAdam optimizer under its own ``cyclic_lr``
    and its freeze mask, ``steps_per_epoch = step_size // 2``;
  * one prefetcher continues across each phase's epoch boundaries; logged
    metrics are epoch means, with a full validation pass and the lr;
  * per-epoch checkpoints named ``"{loss:.5f}-{epoch:02d}"``, then
    ``history.json`` and the MLflow artifacts.

It runs on ``device`` (the CUDA card unless the caller names another).
Data parallelism (the reference's mesh over ``compute.mesh_data`` devices,
clamped to those present): with more than one card asked for and present,
``train_masklab_model`` runs one rank a card, itself rank 0 and the others
spawned, joined over NCCL on a free localhost port; inside a process group
that is already initialised (``parallel.initialize``, the multi-host route)
it trains over that group. Each rank builds only its rows of each global
batch (the same shuffle and scale draws on every rank), runs the parallel
step (``train.steps`` with ``nn.sync.Ranks``), validates over the group
when the valid batch divides by its size (else each rank the whole valid
batch), and only rank 0 writes checkpoints, metrics, history, TensorBoard,
MLflow and the logs; the others wait at a barrier.

Each step of the loop is a ``step`` span (``utils.profiling``) with the
batch's index ``k``, the index the prefetch thread's ``data:batch`` span of
that batch carries; inside it ``stage:data_wait`` (the wait on the
prefetcher), ``stage:pad``, ``stage:upload`` and the step's own
(``stage:forward`` ... ``stage:optimizer``). An epoch's end adds
``stage:validation`` and ``stage:checkpoint``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfiguration
from ..data.dataset import MaskLabDataset
from ..data.generator import (MaskLabGenerator, MultiprocessLoader,
                              PrefetchIterator, pad_boxes_to)
from ..device import resolve_device
from ..models.masklab import build_masklab
from ..nn.sync import Ranks, ranks_of
from ..utils.loggers import (CSVLogger, MLflowLogger, MultiLogger,
                             TensorBoardLogger)
from ..utils.profiling import span
from .checkpoints import CheckpointManager
from .optimizers import chain, cyclic_lr, masked_updates, rectified_adam
from .state import TrainState, trainable_mask
from .steps import as_batch, make_eval_step, make_train_step


def construct_masklab_datasets(config: ModelConfiguration):
    """MaskLabDataset pair from config. When the config names no cases, the
    ETL's split CSVs are used if present (and recorded on the config);
    without them, or without a held-out row, both sets are all images."""
    d = config.dataset
    if not d.train_cases and not d.valid_cases:
        from ..data.process import load_split_cases
        train_cases, valid_cases = load_split_cases(d.data_dir)
        if train_cases is not None:
            d.train_cases = train_cases
            d.valid_cases = valid_cases
    trainset = MaskLabDataset(d.train_cases or None, min_area=d.min_area,
                              data_dir=d.data_dir,
                              instance_labels=d.instance_labels,
                              semantic_labels=d.semantic_labels)
    validset = MaskLabDataset(d.valid_cases or None, min_area=d.min_area,
                              data_dir=d.data_dir,
                              instance_labels=d.instance_labels,
                              semantic_labels=d.semantic_labels)
    return trainset, validset


def data_parallel_size(config: ModelConfiguration,
                       device: torch.device) -> int:
    """``compute.mesh_data`` clamped to the cards present (0 asks for all of
    them), as the reference clamps it to its devices; 1 on the CPU."""
    cards = torch.cuda.device_count() if device.type == 'cuda' else 1
    return max(1, min(config.compute.mesh_data or cards, cards))


class MaskLabTrainer:
    """Owns model/state and runs the progressive-unfreeze schedule."""

    def __init__(self, config: ModelConfiguration,
                 max_gt_boxes: int = 16, log_fn: Callable = print,
                 device=None, ranks: Optional[Ranks] = None):
        """``ranks``: the data-parallel group this trainer is a rank of;
        only rank 0 writes (config.json, the loggers, the log lines)."""
        self.config = config
        self.device = resolve_device(device)
        self.ranks = ranks
        self.writes = ranks is None or ranks.rank == 0
        self.model = build_masklab(config, device=self.device)
        self.max_gt_boxes = max_gt_boxes
        self.log = log_fn if self.writes else (lambda *_: None)
        self.state: Optional[TrainState] = None
        self.ckpt = CheckpointManager(config.train.save_dir,
                                      config if self.writes else None)
        self.history: Dict[str, list] = {}
        self.mlflow = None
        self.metrics_logger = MultiLogger()
        if self.writes:
            self.mlflow = MLflowLogger(
                run_name=os.path.basename(config.train.save_dir.rstrip('/')))
            self.metrics_logger = MultiLogger(
                CSVLogger(os.path.join(config.train.save_dir, 'metrics.csv')),
                TensorBoardLogger(os.path.join(config.train.save_dir, 'tb')),
                self.mlflow)
            self.mlflow.log_params({
                f'{group}.{key}': value
                for group, attrs in config.to_dict().items()
                for key, value in attrs.items()})
        self._global_epoch = 0

    def barrier(self) -> None:
        """Every rank waits here for the others (rank 0's writes)."""
        if self.ranks is not None:
            dist.barrier(group=self.ranks.group)

    # ---- setup ----

    def init_state(self, sample_batch: Dict) -> None:
        """The train state of the seeded model (``build_masklab``); the
        sample batch, which the reference traces its init with, is not
        needed. The optimizer is a placeholder, rebuilt per phase. Every
        rank then holds rank 0's state."""
        self.state = TrainState(self.model, rectified_adam(1e-10),
                                box_beta=self.config.loss.box_loss_beta)
        if self.ranks is not None:
            from ..parallel import replicate_state
            replicate_state(self.state, self.ranks)

    def _phase_tx(self, base_lr, max_lr, step_size, freeze_depth):
        """-> (tx, schedule): one schedule object serves both the
        optimizer and the epoch lr log, so they cannot diverge."""
        schedule = cyclic_lr(base_lr, max_lr, step_size)
        mask = trainable_mask(self.model, self.config.backbone.backbone_type,
                              freeze_depth)
        return chain(rectified_adam(schedule), masked_updates(mask)), schedule

    def _rebuild_state_for_phase(self, tx) -> None:
        """New optimizer per phase (the reference restarted the optimizer
        each phase); parameters, statistics and the box state carry on."""
        box = self.state.box_loss_state
        self.state = TrainState(self.model, tx)
        self.state.box_loss_state = box

    # ---- running ----

    def _prepare(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with span('stage:pad'):
            batch = pad_boxes_to(batch, self.max_gt_boxes)
        with span('stage:upload'):
            return as_batch(batch, self.device)

    def run_phase(self, name: str, generator: MaskLabGenerator,
                  valid_generator: Optional[MaskLabGenerator],
                  epochs: int, base_lr: float, max_lr: float,
                  step_size: int, freeze_depth: str,
                  steps_per_epoch: Optional[int] = None) -> None:
        tx, schedule = self._phase_tx(base_lr, max_lr, step_size,
                                      freeze_depth)
        self._rebuild_state_for_phase(tx)
        step_fn = make_train_step(self.model, seed=self.config.train.seed,
                                  ranks=self.ranks)
        # validation rides the group where the valid generator gives this
        # rank's rows; otherwise every rank evaluates the whole valid batch
        eval_fn = make_eval_step(self.model, ranks=self.ranks if getattr(
            valid_generator, 'shard', None) else None) \
            if valid_generator else None
        steps = steps_per_epoch if steps_per_epoch is not None \
            else max(1, step_size // 2)
        # worker-process batch building when configured; otherwise the
        # in-process thread prefetch
        t = self.config.train
        loader = None
        if t.use_multiprocessing and t.data_workers > 0:
            loader = MultiprocessLoader(
                generator.dataset.get_config(),
                num_workers=t.data_workers,
                batch_size=generator.batch_size,
                scale_ratio=generator.scale_ratio,
                scale_buckets=tuple(generator.scale_buckets),
                shuffle=generator.shuffle, seed=t.seed,
                shard=generator.shard)
        source = loader if loader is not None else generator
        try:
            self._run_epochs(name, source, valid_generator, epochs,
                             schedule, step_fn, eval_fn, steps)
        finally:
            # the spawned worker pool must not leak even if a step raises
            if loader is not None:
                loader.close()

    def _run_epochs(self, name, source, valid_generator, epochs, schedule,
                    step_fn, eval_fn, steps) -> None:
        # ONE prefetcher continues across the phase's epoch boundaries:
        # batches keep advancing through the data, and the source's
        # end-of-iteration shuffle fires at the true end of the data, where
        # the prefetcher is rotated
        prefetcher = PrefetchIterator(source, prefetch=4)
        it = iter(prefetcher)
        try:
            for epoch in range(epochs):
                t0 = time.time()
                step_metrics = []
                for _ in range(steps):
                    with span('step') as step:
                        with span('stage:data_wait'):
                            try:
                                batch = next(it)
                            except StopIteration:
                                prefetcher.close()
                                prefetcher = PrefetchIterator(source,
                                                              prefetch=4)
                                it = iter(prefetcher)
                                batch = next(it)
                        step.set(k=prefetcher.k)
                        self.state, metrics = step_fn(self.state,
                                                      self._prepare(batch))
                    # the device scalars; reading them here would wait for
                    # each step
                    step_metrics.append(metrics)
                self._end_epoch(name, epoch, epochs, t0, step_metrics,
                                valid_generator, eval_fn, schedule)
        finally:
            prefetcher.close()

    def _end_epoch(self, name, epoch, epochs, t0, step_metrics,
                   valid_generator, eval_fn, schedule) -> None:
        """Epoch means, the validation pass, the logs and the checkpoint.
        The metric columns are in sorted order, as the reference's jitted
        steps return them."""
        epoch_metrics = {
            k: float(np.mean([float(m[k]) for m in step_metrics]))
            for k in sorted(step_metrics[0] if step_metrics else {})}
        train_loss = epoch_metrics.get('loss', float('nan'))
        log_line = (f'[{name}] epoch {epoch + 1}/{epochs} '
                    f'loss={train_loss:.5f} ({time.time() - t0:.1f}s)')
        val_loss = None
        if eval_fn is not None and len(valid_generator) > 0:
            with span('stage:validation'):
                vrows = []
                for vi in range(len(valid_generator)):
                    vm = eval_fn(self.state,
                                 self._prepare(valid_generator[vi]))
                    vrows.append({k: float(v) for k, v in vm.items()})
            for k in sorted(vrows[0]):
                epoch_metrics[f'val_{k}'] = float(
                    np.mean([r[k] for r in vrows]))
            val_loss = epoch_metrics['val_loss']
            log_line += f' val_loss={val_loss:.5f}'
        self.log(log_line)
        self.history.setdefault(f'{name}_loss', []).append(train_loss)
        epoch_metrics['train_loss'] = train_loss
        epoch_metrics['lr'] = float(schedule(int(self.state.step)))
        self.metrics_logger.log(self._global_epoch, epoch_metrics)
        self._global_epoch += 1
        with span('stage:checkpoint'):
            if self.writes:
                self.ckpt.save_epoch(self.state, val_loss
                                     if val_loss is not None else train_loss,
                                     epoch)
            self.barrier()

    def smoke_check(self, generator: MaskLabGenerator,
                    num_steps: int = 1) -> None:
        """Tiny-LR fit proving the graph trains and fits in memory; raises
        on a non-finite loss."""
        if num_steps <= 0:
            self.log('smoke check skipped (num_steps=0)')
            return
        tx = chain(rectified_adam(1e-10), masked_updates(trainable_mask(
            self.model, self.config.backbone.backbone_type, 'C0')))
        self._rebuild_state_for_phase(tx)
        step_fn = make_train_step(self.model, with_metrics=False,
                                  ranks=self.ranks)
        for i in range(num_steps):
            batch = self._prepare(generator[i % max(1, len(generator))])
            self.state, metrics = step_fn(self.state, batch)
            loss = float(metrics['loss'])
            if not np.isfinite(loss):
                raise FloatingPointError(f'smoke check loss={loss}')
        self.log(f'smoke check OK — loss={loss:.5f}')


def train_masklab_model(config: ModelConfiguration,
                        max_gt_boxes: int = 16,
                        steps_per_epoch: Optional[int] = None,
                        smoke_steps: int = 1,
                        device=None) -> MaskLabTrainer:
    """The canonical train() entry, on ``device`` (the card by default):
    over the process group where one is initialised, over
    ``data_parallel_size`` cards where that is more than one (this process
    rank 0 on card 0), else in this process. Returns this process's
    trainer."""
    device = resolve_device(device)
    kwargs = dict(max_gt_boxes=max_gt_boxes, steps_per_epoch=steps_per_epoch,
                  smoke_steps=smoke_steps)
    if dist.is_initialized():
        return _train(config, device=device, ranks=ranks_of(None), **kwargs)
    n = data_parallel_size(config, device)
    if n == 1:
        return _train(config, device=device, ranks=None, **kwargs)
    return _train_on_devices(config, [f'cuda:{r}' for r in range(n)],
                             kwargs)


def _train_on_devices(config: ModelConfiguration, devices: List[str],
                      kwargs: Dict) -> MaskLabTrainer:
    """One rank a device: rank 0 here on ``devices[0]``, the others
    spawned."""
    import multiprocessing as mp
    from ..parallel import free_port, initialize
    port = free_port()
    n = len(devices)
    ctx = mp.get_context('spawn')
    workers = [ctx.Process(target=_rank_main,
                           args=(config, devices, r, port, kwargs))
               for r in range(1, n)]
    for w in workers:
        w.start()
    done = False
    try:
        device = initialize(f'localhost:{port}', n, 0, device=devices[0])
        try:
            trainer = _train(config, device=device, ranks=ranks_of(None),
                             **kwargs)
        finally:
            dist.destroy_process_group()
        done = True
    finally:
        for w in workers:
            if not done:
                w.terminate()
            w.join()
    failed = [r for r, w in enumerate(workers, 1) if w.exitcode != 0]
    if failed:
        raise RuntimeError(f'data-parallel training: ranks {failed} failed')
    return trainer


def _rank_main(config: ModelConfiguration, devices: List[str], r: int,
               port: int, kwargs: Dict) -> None:
    """A spawned rank of ``_train_on_devices``."""
    from ..parallel import initialize
    device = initialize(f'localhost:{port}', len(devices), r,
                        device=devices[r])
    try:
        _train(config, device=device, ranks=ranks_of(None), **kwargs)
    finally:
        dist.destroy_process_group()


def _train(config: ModelConfiguration, max_gt_boxes: int,
           steps_per_epoch: Optional[int], smoke_steps: int, device,
           ranks: Optional[Ranks]) -> MaskLabTrainer:
    """The run itself, in this process: one rank of ``ranks`` or alone."""
    t = config.train
    os.makedirs(t.save_dir, exist_ok=True)
    shard = None if ranks is None else (ranks.rank, ranks.world)

    trainset, validset = construct_masklab_datasets(config)
    train_gen = MaskLabGenerator(
        trainset.get_config(), scale_ratio=t.scale_ratio,
        batch_size=t.batch_size,
        scale_buckets=config.compute.scale_buckets, seed=t.seed, shard=shard)
    # valid batch = 4x train batch, clamped so small validation sets still
    # yield at least one full batch
    valid_batch = min(t.batch_size * 4, t.max_batch_size,
                      max(1, len(validset)))
    valid_gen = MaskLabGenerator(
        validset.get_config(), scale_ratio=t.scale_ratio,
        batch_size=valid_batch,
        scale_buckets=config.compute.scale_buckets,
        shard=shard if shard and valid_batch % shard[1] == 0 else None) \
        if len(validset) else None

    trainer = MaskLabTrainer(config, max_gt_boxes=max_gt_boxes,
                             device=device, ranks=ranks)
    trainer.init_state(train_gen[0])
    # the smoke check runs at the LARGEST scale bucket: the worst-case
    # memory must fit before real training
    max_scale = max(train_gen.scale_buckets)
    smoke_gen = MaskLabGenerator(
        trainset.get_config(), scale_ratio=(max_scale, max_scale),
        batch_size=t.batch_size, scale_buckets=(max_scale,), shuffle=False,
        shard=shard)
    trainer.smoke_check(smoke_gen, num_steps=smoke_steps)

    if t.train_head_tune:
        trainer.run_phase('head', train_gen, valid_gen,
                          t.train_head_tune_epoch, t.head_base_lr,
                          t.head_max_lr, t.head_step_size,
                          t.train_head_level, steps_per_epoch)
    if t.train_waist_tune:
        trainer.run_phase('waist', train_gen, valid_gen,
                          t.train_waist_tune_epoch, t.waist_base_lr,
                          t.waist_max_lr, t.waist_step_size,
                          t.train_waist_level, steps_per_epoch)
    if t.train_all:
        trainer.run_phase('all', train_gen, valid_gen, t.train_all_epoch,
                          t.all_base_lr, t.all_max_lr, t.all_step_size,
                          'C0', steps_per_epoch)
    if trainer.writes:
        with open(os.path.join(t.save_dir, 'history.json'), 'w') as f:
            json.dump(trainer.history, f, indent=2)
        for artifact in ('history.json', 'metrics.csv', 'config.json'):
            path = os.path.join(t.save_dir, artifact)
            if os.path.exists(path):
                trainer.mlflow.log_artifact(path)
        best = trainer.ckpt.best_checkpoint()
        if best is not None:
            trainer.mlflow.log_artifact_dir(best, os.path.basename(best))
    trainer.metrics_logger.close()
    trainer.barrier()
    return trainer
