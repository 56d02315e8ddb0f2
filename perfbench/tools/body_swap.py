"""A served cell's readings with another body under its configuration, on
the card: the starting readings of a configuration that has no cell yet.

    python3 perfbench/tools/body_swap.py --workload resnet50-batch-summarize
        --body efficientnetb4 --seeds 1,2 --trace-seeds 3
        --control-seeds 4,5,6 --seconds 20

Each run is ``perfbench/run.py``'s (the cell's driver, traffic, judged
frames and judge; the benchmark's weights of the seed) on the cell's
configuration with ``backbone.backbone_type`` set to ``--body`` and nothing
else changed (without ``--body``, the cell as it is), all in one process.
One JSON line a run: the seed, the numbers compared (beside the cell's own
limits), the end-to-end metrics (untraced; ``setup_s`` holds only for the
process's first run) or the per-layer metrics, among them the forward's
split by the program's spans, and the idle share (traced), and the
device's peak; then one line a control seed (``tools/control.py``'s
readings)."""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from types import SimpleNamespace
from typing import Dict, List, Optional

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

# torch comes after env.set_cache_dirs()
from perfbench.harness import env, main, spec  # noqa: E402


def swapped_config(bench: Dict, workload: str,
                   body: Optional[str]) -> Dict:
    config = copy.deepcopy(spec.config_of(bench, spec.cell_of(bench,
                                                              workload)))
    if body:
        config['model']['backbone']['backbone_type'] = body
    return config


def run_once(bench: Dict, workload: str, config: Dict, seed: int,
             seconds: float, trace: bool) -> Optional[Dict]:
    import torch
    torch.cuda.reset_peak_memory_stats()
    args = SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                           trace=int(trace))
    out = main.run_cell(args, bench, config=config)
    if out is None:
        return None
    line = dict(seed=seed, trace=trace, correct=out['correct'],
                checks={k: v['value'] for k, v in out['checks'].items()},
                metrics={k: v['value'] for k, v in out['metrics'].items()},
                peak_gib=out['device']['memory_peak_bytes'] / 2 ** 30)
    if trace:
        line['idle_share'] = 100.0 * (1 - out['device']['busy_s']
                                      / out['device']['window_s'])
    return line


def seeds(text: str) -> List[int]:
    return [int(s) for s in text.split(',') if s]


def cli(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog='perfbench/tools/body_swap.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--body', default=None)
    p.add_argument('--seeds', default='')
    p.add_argument('--trace-seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--seconds', type=float, default=20.0)
    args = p.parse_args(argv)
    env.set_cache_dirs()
    bench = spec.load_benchmark()
    config = swapped_config(bench, args.workload, args.body)
    runs = ([(s, False) for s in seeds(args.seeds)]
            + [(s, True) for s in seeds(args.trace_seeds)])
    for seed, trace in runs:
        line = run_once(bench, args.workload, config, seed, args.seconds,
                        trace)
        if line is None:
            return 2
        print(json.dumps(dict(line, body=args.body)), flush=True)
    from perfbench.tools.control import readings
    for seed in seeds(args.control_seeds):
        print(json.dumps(dict(seed=seed, body=args.body, control=readings(
            args.workload, seed, config=config))), flush=True)
    found = env.forbidden_modules()
    if found:
        print(f'body_swap: JAX modules loaded: {found}', file=sys.stderr)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(cli(sys.argv[1:]))
