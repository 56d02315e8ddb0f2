"""The precision control's readings at a cell's own size, on the card:

    python3 perfbench/tools/control.py --workload <cell> --seeds 1,2,3

For each seed, the frames a run of that seed judges, the benchmark's
weights of that seed, and the reference in float8 put in the program's
place (``reference/control.py``); one JSON line of readings a seed. The
limits in ``limits/<cell>.json`` sit between the program's readings and
these."""
from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def judged_frames(cell, traffic, seed: int, seconds: float):
    """The frames a batch run of ``seed`` judges (the driver's own draw)."""
    import numpy as np
    from perfbench.harness import frames
    rng = np.random.default_rng(seed)
    hw = tuple(traffic['frame_hw'])
    drawn = [frames.road_frame(rng, hw, traffic['noise'])
             for _ in range(traffic['batch'] * traffic['distinct_batches'])]
    picks = rng.choice(len(drawn), traffic['judged'], replace=False)
    return [drawn[int(p)] for p in sorted(picks)]


def train_batches(ctx, count: int):
    """The first ``count`` batches a training cell's steps get, made as
    the trainer makes them (the dataset, the ETL, the generator's order and
    buckets, ``_prepare``'s padding and upload)."""
    from masklab_tpu_torch.data import MaskLabGenerator
    from masklab_tpu_torch.data.generator import pad_boxes_to
    from masklab_tpu_torch.data.process import process_dataset
    from masklab_tpu_torch.train.steps import as_batch
    from masklab_tpu_torch.train.trainer import construct_masklab_datasets
    from perfbench.harness import dataset
    cfg = ctx.port_config()
    cfg.dataset.data_dir = os.path.join(ctx.workdir, 'data')
    t = ctx.traffic
    dataset.write_dataset(cfg.dataset.data_dir, ctx.seed, t['frames'],
                          tuple(t['frame_hw']), t['noise'])
    process_dataset(cfg.dataset.data_dir,
                    except_semantic_labels=cfg.dataset.except_semantic_labels,
                    num_workers=1)
    trainset, _ = construct_masklab_datasets(cfg)
    tr = cfg.train
    gen = MaskLabGenerator(trainset.get_config(), scale_ratio=tr.scale_ratio,
                           batch_size=tr.batch_size,
                           scale_buckets=cfg.compute.scale_buckets,
                           seed=tr.seed)
    out = []
    for batch in gen:
        out.append(as_batch(pad_boxes_to(batch, 16), ctx.device))
        if len(out) == count:
            return out
    return out


def readings(workload: str, seed: int, device: str = 'cuda', config=None,
             traffic=None, seconds=None):
    from perfbench.harness import spec
    from perfbench.harness.main import Context
    from perfbench.reference.control import control_numbers
    bench = spec.load_benchmark()
    cell = spec.cell_of(bench, workload)
    config = config or spec.config_of(bench, cell)
    traffic = traffic or spec.traffic_of(cell)
    seconds = seconds or bench['run_seconds']
    ctx = Context(cell, config, traffic, seed, seconds, False, device)
    try:
        if traffic['driver'] == 'trainer':
            from perfbench.drivers.trainer import Session
            from perfbench.reference.train import control_steps
            return control_steps(config['model'], ctx.weights(),
                                 train_batches(ctx, traffic['checked_steps']),
                                 Session(ctx)._phase(), device)
        return control_numbers(config['model'], ctx.weights(),
                               judged_frames(cell, traffic, seed, seconds),
                               device)
    finally:
        ctx.close()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    args = p.parse_args()
    from perfbench.harness import env
    env.set_cache_dirs()
    for seed in args.seeds.split(','):
        print(json.dumps(dict(workload=args.workload, seed=int(seed),
                              control=readings(args.workload, int(seed)))),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
