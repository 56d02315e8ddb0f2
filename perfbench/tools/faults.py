"""Faults planted under a run's timed path, to show that ``correct`` comes
out false: each is a context manager that patches one program function
and restores it.

    python3 perfbench/tools/faults.py --workload <cell> --fault <name>
        --seeds 1,2,3 --seconds <s>

runs the cell on the card with the fault planted (a JSON line of the
compared numbers a seed): the readings a training cell's limits are held
against."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


@contextlib.contextmanager
def _patched(obj, name, make):
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def proposals_moved():
    """A proposal box moved after the NMS made it."""
    from masklab_tpu_torch.models.masklab import MaskLab

    def make(original):
        def moved(self, out):
            rows = original(self, out)
            rows[:, 0, 0] += 7.0
            return rows
        return moved
    return _patched(MaskLab, 'proposals', make)


def masks_altered():
    """The mask branch's masks flipped along their rows."""
    from masklab_tpu_torch.models.masklab import MaskLab

    def make(original):
        def altered(self, *args):
            return torch.flip(original(self, *args), dims=[2])
        return altered
    return _patched(MaskLab, 'mask_branch', make)


def rows_altered():
    """Every analytics row's x moved where the rows are made."""
    from masklab_tpu_torch.serving import predictor

    def make(original):
        def altered(*args, **kwargs):
            summary, union = original(*args, **kwargs)
            summary = summary.clone()
            summary[..., 1] += 500.0
            return summary, union
        return altered
    return _patched(predictor, 'fused_summary_union', make)


def half_batch_answered():
    """Half of a batch computed, its outputs answering the other half."""
    from masklab_tpu_torch.serving.predictor import MaskLabPredictor

    def make(original):
        def half(self, images, mode=None):
            n = len(images)
            out = original(self, images[:max(1, n // 2)], mode)
            return {k: np.concatenate([v] * 2)[:n] for k, v in out.items()}
        return half
    return _patched(MaskLabPredictor, 'predict', make)


def state_unchanged():
    """A train step that leaves the parameters and optimizer state as they
    were."""
    from masklab_tpu_torch.train.state import TrainState
    return _patched(TrainState, 'apply_gradients',
                    lambda original: lambda self, grads: None)


def half_batch_loss():
    """A train step's losses over the first half of its batch, the mean
    taken over the rest."""
    from masklab_tpu_torch.train import steps

    def make(original):
        def half(model, out, batch, *args, **kwargs):
            b = batch['images'].shape[0]
            n = b // 2

            def cut(v):
                if torch.is_tensor(v) and v.dim() and v.shape[0] == b:
                    return v[:n]
                if isinstance(v, list):
                    return [cut(x) for x in v]
                return v
            return original(model, {k: cut(v) for k, v in out.items()},
                            {k: cut(v) for k, v in batch.items()},
                            *args, **kwargs)
        return half
    return _patched(steps, 'losses_of', make)


def mask_loss_dropped():
    """A train step whose total leaves the mask head's loss out (its
    gradients nought): a fault confined to one head."""
    from masklab_tpu_torch.train import steps
    return _patched(steps, 'mask_loss',
                    lambda original: lambda *a, **k: original(*a, **k) * 0)


FAULTS = {f.__name__: f for f in (
    proposals_moved, masks_altered, rows_altered, half_batch_answered,
    state_unchanged, half_batch_loss, mask_loss_dropped)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--fault', required=True, choices=sorted(FAULTS))
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    args = p.parse_args()
    from types import SimpleNamespace
    from perfbench.harness import env, main as harness, spec
    env.set_cache_dirs()
    bench = spec.load_benchmark()
    for seed in args.seeds.split(','):
        with FAULTS[args.fault]():
            out = harness.run_cell(SimpleNamespace(
                workload=args.workload, seed=int(seed),
                seconds=args.seconds, trace=0), bench)
        print(json.dumps(dict(workload=args.workload, fault=args.fault,
                              seed=int(seed), correct=out['correct'],
                              checks=out['checks'])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
