"""The spread of a cell's end-to-end metrics over sets of runs, and the
bound it asks for:

    python3 perfbench/tools/spread.py set1.jsonl set2.jsonl ...

Each file holds one set: the result line of each run, one a line. For each
metric: each set's median and spread (the distance between the first and
third quartile of ``statistics.quantiles(values, n=4)``, as a share of the
median), and five times the widest spread (never under 1%); for
``setup_s`` the medians' ratio, which its bound of 0.25 must cover."""
from __future__ import annotations

import json
import os
import sys

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def read_sets(paths):
    sets = []
    for path in paths:
        with open(path) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    return sets


def summary(sets) -> dict:
    from perfbench.harness.stats import median, spread
    names = sorted({m for s in sets for r in s for m in r['metrics']})
    out = {}
    for name in names:
        per_set = [[r['metrics'][name]['value'] for r in s
                    if name in r['metrics']] for s in sets]
        spreads = [spread(v) for v in per_set if len(v) >= 2]
        out[name] = dict(medians=[median(v) for v in per_set if v],
                         spreads=spreads,
                         bound=max(0.01, 5 * max(spreads, default=0.0)))
    return out


def main() -> int:
    print(json.dumps(summary(read_sets(sys.argv[1:])), indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
