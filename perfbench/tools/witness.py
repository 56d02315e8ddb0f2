"""The float32 witness of a training cell: the program run as the cell
runs it, but in float32 with TF32 off, and judged as a run is:

    python3 perfbench/tools/witness.py --workload <cell> --seeds 1,2,3
        --seconds <s>

One JSON line a seed: every reading of the checked steps, the worst single
leaves among them. Where the bfloat16 program's worst leaves read far
above the witness's, their gap comes from the precision the cell runs in,
not from a fault of the steps."""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, required=True)
    args = p.parse_args()
    from types import SimpleNamespace
    from perfbench.harness import env, main as harness, spec
    env.set_cache_dirs()
    import torch
    from perfbench.reference import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.load_benchmark()
    config = copy.deepcopy(spec.config_of(bench,
                                          spec.cell_of(bench, args.workload)))
    config['model']['compute']['compute_dtype'] = 'float32'
    kept = {}
    compared = train.compared

    def keep(gaps):
        kept.update(gaps)
        return compared(gaps)
    train.compared = keep
    for seed in args.seeds.split(','):
        kept.clear()
        out = harness.run_cell(SimpleNamespace(
            workload=args.workload, seed=int(seed), seconds=args.seconds,
            trace=0), bench, config=config)
        print(json.dumps(dict(workload=args.workload, witness='float32',
                              seed=int(seed), readings=dict(kept))),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
