"""One run of one cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell's configuration, traffic and limits are found by name
(``harness.spec``); its traffic's driver sets up the program, runs the
window and hands over what the timed path made. Then, with the program's
state freed, the plain reference judges it (``reference.judge``). The last
line of standard output is the result's JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key. A run without a card (or with fewer than the cell asks
for) exits 2 and prints no result; one that finds a JAX module loaded
exits 3."""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from . import env, spec


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record)."""
    with open('/proc/self/stat') as f:
        start_ticks = float(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    seed, the window's length, the device, a scratch directory under
    ``TMPDIR``, the benchmark's weights, and the traced run's profiler
    (``trace_start`` / ``trace_stop``, called in the thread that drives the
    device)."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict, seed: int,
                 seconds: float, trace: bool, device: str = 'cuda'):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.workdir = tempfile.mkdtemp(prefix='perfbench-')
        self._weights = None
        self.tracer = None
        self.kernel_calls = None
        from .trace import Marks
        self.mark = Marks()

    def port_config(self):
        """The program's configuration object for this cell."""
        import copy
        from masklab_tpu_torch.config import ModelConfiguration
        cfg = ModelConfiguration().from_dict(copy.deepcopy(
            self.config['model']))
        cfg.train.save_dir = os.path.join(self.workdir, 'run')
        return cfg

    def weights(self):
        """The benchmark's float32 state dict for the configuration, on the
        device, drawn from the seed (made once)."""
        if self._weights is None:
            import torch
            from ..reference import pipeline
            from ..reference.masklab_plain.models.masklab import MaskLab
            from .weights import seeded_state
            with torch.device('meta'):
                shape = MaskLab(pipeline.config(self.config['model']))
            self._weights = seeded_state(
                shape, self.seed, self.device,
                self.config['weights']['force_dense'])
        return self._weights

    def synchronize(self) -> None:
        import torch
        if self.device != 'cpu':
            torch.cuda.synchronize()

    def trace_start(self) -> bool:
        """Start the traced run's profiler and marks; False in an untraced
        run."""
        if not self.trace or self.tracer is not None:
            return False
        from .trace import KernelCalls, Trace
        self.kernel_calls = KernelCalls().install()
        self.tracer = Trace(self.device)
        self.tracer.start()
        self.mark.on = self.device != 'cpu'
        return True

    def trace_stop(self) -> None:
        if self.tracer is not None and self.tracer.active:
            self.mark.on = False
            self.tracer.stop()
            self.kernel_calls.remove()

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi not readable'


def judge(ctx: Context, judged: List[Dict]) -> Dict[str, float]:
    """The worst reading of each compared number over the judged frames,
    the reference run frame by frame on the device, and ``judged_missing``:
    the judged frames for which the timed path handed over nothing."""
    from ..reference import judge as judge_mod
    from ..reference import pipeline
    if judged and judged[0].get('kind') == 'train':
        from ..reference.train import judge_steps
        labels = list(ctx.config['model']['dataset']['instance_labels'])
        return judge_steps(ctx.config['model'], judged[0], ctx.device,
                           labels)
    model = pipeline.build(ctx.config['model'], ctx.weights(), ctx.device)
    cfg = pipeline.config(ctx.config['model'])
    present = [j for j in judged if j['program'] is not None]
    readings = [judge_mod.judge_frame(model, cfg, j['frame'], j['program'],
                                      j['rows']) for j in present]
    return dict(judge_mod.worst(readings),
                judged_missing=len(judged) - len(present))


def layer_metrics(bench: Dict, cell: str, run: Dict) -> Dict:
    out = {}
    for m in spec.reported(bench, cell, trace=True):
        value = spec.reader(m['name'])(run)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def run_cell(args, bench: Dict, device: str = 'cuda',
             check_card: bool = True, config=None, traffic=None,
             limits=None) -> Optional[Dict]:
    """The run; -> the result object (None where no card). The tests run
    it on the CPU at a small size: ``config``, ``traffic`` and ``limits``
    then stand in for the cell's files."""
    cell = spec.cell_of(bench, args.workload)
    config = config or spec.config_of(bench, cell)
    traffic = traffic or spec.traffic_of(cell)
    import torch
    if check_card:
        problem = env.card_problem(cell['chips'])
        if problem:
            print(f'perfbench: no run: {problem}', file=sys.stderr)
            return None
        from masklab_tpu_torch.utils.profiling import enable_compilation_cache
        enable_compilation_cache(env.kernel_build_dir())
        torch.cuda.set_device(0)
    print(f'card: {card_line() if device != "cpu" else "cpu"}',
          file=sys.stderr, flush=True)
    ctx = Context(cell, config, traffic, args.seed, args.seconds,
                  bool(args.trace), device)
    try:
        driver = spec.driver(traffic['driver'])
        session = driver.Session(ctx)
        session.setup()
        if ctx.trace and device != 'cpu':
            from .trace import warm_profiler
            warm_profiler()
        setup_s = process_age_s()
        result = session.window()
        peak = (torch.cuda.max_memory_allocated() if device != 'cpu' else 0)
        judged = session.judged()
        session.close()
        del session
        gc.collect()
        if device != 'cpu':
            torch.cuda.empty_cache()
        numbers = judge(ctx, judged)
    finally:
        ctx.trace_stop()
        ctx.close()
    from ..reference.judge import verdict
    limits = limits or spec.limits_of(cell['name'])
    correct, rows = verdict(numbers, limits)
    correct = correct and result['failed'] == 0 and bool(judged)
    out = dict(correct=correct, attempted=result['attempted'],
               failed=result['failed'])
    units = {m['name']: m['unit'] for m in bench['end_to_end']}
    device_info = dict(platform='gpu' if device != 'cpu' else 'cpu',
                       kind=(torch.cuda.get_device_name(0)
                             if device != 'cpu' else 'cpu'),
                       count=cell['chips'], memory_peak_bytes=int(peak))
    if args.trace:
        tr = ctx.tracer
        from .trace import check_marks, roofline_shares
        if tr is not None and device != 'cpu':
            check_marks(tr.marks, result['counters'].get('calls'))
        run = dict(cell=cell['name'], trace=tr, counters=result['counters'],
                   roofline=(roofline_shares(tr, ctx.kernel_calls)
                             if tr is not None else {}),
                   flops_per_frame=_flops(ctx), peak_bytes=peak,
                   device=device)
        out['metrics'] = layer_metrics(bench, cell['name'], run)
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
            out['breakdown'] = dict(
                device_ops=[[n, s] for n, s in tr.device_ops],
                idle_gaps=[[n, s] for n, s in tr.idle_gaps])
    else:
        values = dict(result['e2e'],
                      setup_s=result.get('setup_s', setup_s))
        out['metrics'] = {m['name']: {'value': float(values[m['name']]),
                                      'unit': units[m['name']]}
                          for m in spec.reported(bench, cell['name'], False)}
        # what the session measured that is no end-to-end metric of the cell
        for name in sorted(set(result['e2e']) - set(out['metrics'])):
            print(f'window {name}: {result["e2e"][name]}', file=sys.stderr)
    out['device'] = device_info
    out['checks'] = {name: {'value': value, 'limit': limit}
                     for name, value, limit in rows}
    return out


def _flops(ctx: Context) -> float:
    from ..reference.pipeline import forward_flops
    if ctx.traffic['driver'] == 'trainer':
        return 0.0           # the driver counts its steps' own
    h, w = ctx.traffic['frame_hw']
    res = ctx.config['model']['postprocess']['resolution']
    ratio = min(res[0] / h, res[1] / w)
    return forward_flops(ctx.config['model'],
                         (int(ratio * h), int(ratio * w)))['forward']


def parse(argv: List[str]):
    p = argparse.ArgumentParser(prog='perfbench/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str]) -> int:
    args = parse(argv)
    env.set_cache_dirs()
    bench = spec.load_benchmark()
    out = run_cell(args, bench)
    if out is None:
        return 2
    found = env.forbidden_modules()
    if found:
        print(f'perfbench: JAX modules loaded: {found}', file=sys.stderr)
        return 3
    print(f'correct: {out["correct"]}', file=sys.stderr)
    for name, check in out['checks'].items():
        print(f'check {name}: {check["value"]} (limit {check["limit"]})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

