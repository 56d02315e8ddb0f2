"""Find a cell's pieces by the names in ``BENCHMARK.json``."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, 'BENCHMARK.json'))


def cell_of(bench: Dict, name: str) -> Dict:
    for cell in bench['workloads']:
        if cell['name'] == name:
            return cell
    raise KeyError(f'no workload named {name!r} in BENCHMARK.json')


def config_of(bench: Dict, cell: Dict, root: str = ROOT) -> Dict:
    """The configuration file of the cell's ``config``."""
    for entry in bench['configs']:
        if entry['name'] == cell['config']:
            return _json(os.path.join(root, entry['file']))
    raise KeyError(f'no configuration named {cell["config"]!r}')


def traffic_of(cell: Dict) -> Dict:
    """``traffic/<traffic>.json``: the mix's parameters and its driver."""
    return _json(os.path.join(PERFBENCH, 'traffic', cell['traffic'] + '.json'))


def limits_of(cell_name: str) -> Dict[str, float]:
    """``limits/<cell>.json``: each compared number's limit (the readings it
    was set from sit beside it in the file)."""
    data = _json(os.path.join(PERFBENCH, 'limits', cell_name + '.json'))
    return {k: float(v['limit']) for k, v in data['numbers'].items()}


def driver(kind: str):
    """``drivers/<kind>.py``, the code that runs a kind of traffic."""
    return importlib.import_module(f'perfbench.drivers.{kind}')


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read(run)``: the metric's value from a
    traced run, or None where the run holds nothing to read."""
    path = os.path.join(PERFBENCH, 'metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reported(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell prints: with ``trace`` its per-layer
    metrics, else its end-to-end ones (a metric without ``workloads`` is in
    every cell)."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group
            if cell_name in m.get('workloads', [cell_name])]
