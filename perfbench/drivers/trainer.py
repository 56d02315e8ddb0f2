"""Training on the users' labels: ``MaskLabTrainer.run_phase`` of one
phase of the schedule, with its data pipeline (the ETL over a labelled
dataset drawn from the seed, ``MaskLabGenerator`` behind the in-process
prefetcher) and its data waits inside the window.

Set-up writes the dataset (``harness.dataset``), runs the port's ETL in
process (``num_workers=1``), builds the trainer on the benchmark's weights
and warms every scale bucket's train step on a copy of the model (the
trainer's own state is not touched). The window is the phase's own loop:
``run_phase`` runs with more steps than the window holds; its first
``checked_steps`` steps are checked against the reference, and the window
opens when they are done (the trainer handed on as it is) and closes at
the first step that ends ``--seconds`` later, synchronized: the harness's
step wrapper then stops the loop (``WindowClosed``), so the epoch's end
(validation, checkpoint) never runs inside it. The harness wraps, without
changing what they do: the trainer's step maker (timing and checking the
steps), ``_prepare`` (the batch as the step gets it; the data wait before
it), the steps' ``gradients`` (the backward's host time) and the model's
loss-NMS (its proposals, replayed by the reference).

Traffic parameters: ``phase`` (head / waist / all: the configuration's
epochs, learning rates and freeze depth of that phase), ``frames``,
``frame_hw``, ``noise``, ``checked_steps``."""
from __future__ import annotations

import copy
import os
import time
from typing import Dict, List

import torch

from ..harness import dataset
from ..harness.main import process_age_s

STEP_CAP = 1_000_000


class WindowClosed(Exception):
    """Raised by the step wrapper once the window has run its time."""


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.trainer = None

    def setup(self) -> None:
        from masklab_tpu_torch.data import MaskLabGenerator
        from masklab_tpu_torch.data.process import process_dataset
        from masklab_tpu_torch.train import TrainState, rectified_adam
        from masklab_tpu_torch.train.steps import make_train_step
        from masklab_tpu_torch.train.trainer import (
            MaskLabTrainer, construct_masklab_datasets)
        ctx, t = self.ctx, self.t
        cfg = ctx.port_config()
        cfg.dataset.data_dir = os.path.join(ctx.workdir, 'data')
        self.written = dataset.write_dataset(
            cfg.dataset.data_dir, ctx.seed, t['frames'],
            tuple(t['frame_hw']), t['noise'])
        process_dataset(cfg.dataset.data_dir,
                        except_semantic_labels=cfg.dataset.except_semantic_labels,
                        num_workers=1)
        trainset, _ = construct_masklab_datasets(cfg)
        tr = cfg.train
        self.generator = MaskLabGenerator(
            trainset.get_config(), scale_ratio=tr.scale_ratio,
            batch_size=tr.batch_size,
            scale_buckets=cfg.compute.scale_buckets, seed=tr.seed)
        self.trainer = MaskLabTrainer(cfg, device=ctx.device,
                                      log_fn=lambda *a: None)
        self.trainer.model.load_state_dict(ctx.weights())
        self.trainer.init_state(None)
        self.state0 = {k: v.detach().clone()
                       for k, v in self.trainer.model.state_dict().items()}
        # every bucket's step once, on a copy of the model
        twin = copy.deepcopy(self.trainer.model)
        step = make_train_step(twin, seed=tr.seed)
        state = TrainState(twin, rectified_adam(1e-10),
                           box_beta=cfg.loss.box_loss_beta)
        rows = trainset[0:tr.batch_size]
        for scale in self.generator.scale_buckets:
            batch = self.generator.rescale_batch(rows, scale)
            state, metrics = step(state, self.trainer._prepare(batch))
            float(metrics['loss'])
        del twin, state, step
        ctx.synchronize()
        if ctx.device != 'cpu':
            torch.cuda.empty_cache()

    def _phase(self) -> Dict:
        c, name = self.ctx.port_config().train, self.t['phase']
        return dict(
            epochs=getattr(c, {'head': 'train_head_tune_epoch',
                               'waist': 'train_waist_tune_epoch',
                               'all': 'train_all_epoch'}[name]),
            base=getattr(c, f'{name}_base_lr'),
            max=getattr(c, f'{name}_max_lr'),
            step_size=getattr(c, f'{name}_step_size'),
            freeze={'head': c.train_head_level, 'waist': c.train_waist_level,
                    'all': 'C0'}[name])

    def window(self) -> Dict:
        from masklab_tpu_torch.models import masklab as masklab_module
        from masklab_tpu_torch.train import steps as steps_module
        from masklab_tpu_torch.train import trainer as trainer_module
        ctx, t, trainer = self.ctx, self.t, self.trainer
        checked = t['checked_steps']
        rec = dict(batches=[], proposals=[], losses=[], shapes=[],
                   waits=[], backward_s=[], nms_calls=0)
        clock = dict(step_end=None, open=None, steps=0)
        self.rec = rec

        def prepare(batch, _orig=trainer._prepare):
            now = time.perf_counter()
            if clock['step_end'] is not None and clock['open'] is not None:
                rec['waits'].append(now - clock['step_end'])
            out = _orig(batch)
            if len(rec['batches']) < checked:
                rec['batches'].append({k: v.clone() for k, v in out.items()})
            return out

        def gradients(total, params, _orig=steps_module.gradients):
            t0 = time.perf_counter()
            out = _orig(total, params)
            if clock['open'] is not None:
                rec['backward_s'].append(time.perf_counter() - t0)
            return out

        nms = masklab_module.batched_class_aware_nms

        def loss_nms(*args, **kwargs):
            out = nms(*args, **kwargs)
            # the first call of a step is the loss-config NMS
            if rec['nms_calls'] % 2 == 0 and len(rec['proposals']) < checked:
                rec['proposals'].append(out.clone())
            rec['nms_calls'] += 1
            return out

        def make_step(*args, _orig=trainer_module.make_train_step, **kwargs):
            inner = _orig(*args, **kwargs)

            def step(state, batch):
                k = len(rec['losses']) + 1 if clock['open'] is None else None
                if k == 1:
                    rec['start'] = {n: p.detach().clone()
                                    for n, p in state.params.items()}
                state, metrics = inner(state, batch)
                if clock['open'] is None:
                    rec['losses'].append(float(metrics['loss']))
                    if k == 1:
                        rec['mu'] = {n: v.detach().clone() for n, v in
                                     state.opt_state[0].mu.items()}
                    if k == checked:
                        rec['after'] = {n: p.detach().clone()
                                        for n, p in state.params.items()}
                        rec['stats'] = {n: v.detach().clone() for n, v in
                                        state.batch_stats.items()}
                        rec['box'] = tuple(v.detach().clone() for v in
                                           state.box_loss_state)
                        ctx.synchronize()
                        rec['setup_s'] = process_age_s()
                        ctx.trace_start()
                        clock['open'] = time.perf_counter()
                else:
                    clock['steps'] += 1
                    rec['shapes'].append(tuple(batch['images'].shape))
                    if time.perf_counter() - clock['open'] >= ctx.seconds:
                        ctx.synchronize()
                        clock['close'] = time.perf_counter()
                        raise WindowClosed
                clock['step_end'] = time.perf_counter()
                return state, metrics
            return step

        patches = [(trainer, '_prepare', prepare),
                   (steps_module, 'gradients', gradients),
                   (masklab_module, 'batched_class_aware_nms', loss_nms),
                   (trainer_module, 'make_train_step', make_step)]
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        p = self._phase()
        try:
            trainer.run_phase(t['phase'], self.generator, None, 1, p['base'],
                              p['max'], p['step_size'], p['freeze'],
                              steps_per_epoch=STEP_CAP)
        except WindowClosed:
            pass
        finally:
            for obj, name, fn in saved:
                if name == '_prepare':
                    del trainer._prepare
                else:
                    setattr(obj, name, fn)
            ctx.trace_stop()
        window_s = clock['close'] - clock['open']
        images = clock['steps'] * self.generator.batch_size
        flops = sum(self._step_flops(shape) for shape in rec['shapes'])
        # the rate spreads from run to run with the host (PERF.md section
        # 2): printed, not bounded; the device's peak is the bounded reading
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if ctx.device != 'cpu' else 0.0)
        return dict(
            attempted=images, failed=0, setup_s=rec['setup_s'],
            e2e={'train_img_per_s': images / window_s,
                 'train_peak_gib': peak},
            counters=dict(window_s=window_s, steps=clock['steps'],
                          traced_frames=images, flops=flops,
                          data_wait_s=sum(rec['waits']),
                          backward_s=rec['backward_s']))

    def _step_flops(self, shape) -> float:
        """A train step's operations at its images' shape: forward and
        backward (three forwards) of each image, the mask heads over the
        gt boxes and the loss-NMS proposals."""
        from ..reference.pipeline import forward_flops
        key = tuple(shape[1:3])
        cache = self.__dict__.setdefault('_flops', {})
        if key not in cache:
            m = self.ctx.config['model']
            rois = 16 + m['loss']['nms_max_output_size']
            cache[key] = 3 * forward_flops(m, key, rois)['forward']
        return cache[key] * shape[0]

    def judged(self) -> List[Dict]:
        """One entry: the checked steps' record."""
        rec = self.rec
        return [dict(kind='train', state0=self.state0,
                     batches=rec['batches'], proposals=rec['proposals'],
                     losses=rec['losses'], mu=rec['mu'],
                     start=rec['start'], after=rec['after'],
                     stats=rec['stats'], box=rec['box'],
                     written=self.written, lr=self._phase())]

    def close(self) -> None:
        self.trainer = None
