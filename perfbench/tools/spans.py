"""A run of one cell with the program's span recorder on, and the metrics
that read its spans and counters (``harness/spans.py``):

    python3 perfbench/tools/spans.py --workload road-train-all --seed <n>
        --seconds 51 --trace 1 [--recorder 0|1]

It is ``perfbench/run.py``'s run (the same traffic, window, trace and
judge) with a harness that turns the recorder on when the window opens
(``Context.trace_start``, in untraced runs too) and drains it when the
window closes, into ``run['spans']`` and ``run['program_counts']``.
``--recorder 0`` runs the same harness with the recorder off, for the
recorder's cost. The last line of standard output is the result's JSON
object, with these keys beside ``run.py``'s:

- ``span_metrics``: each ``SPAN_METRICS`` entry's reading (``metrics/
  <name>.py``), where the run holds something for it;
- ``span_extras`` (traced runs): the idle seconds of the window under each
  innermost span of the loop thread (``idle_s``), the device's idle share,
  the span-based data wait beside the patched one, the decodes a batch and
  the counters;
- ``e2e_traced``: the cell's end-to-end rate measured over the traced
  window, for the cost of tracing;
- ``clock`` (traced runs on a card): spans opened around a
  ``torch.cuda._sleep`` launch at the window's start and end against
  those kernels' starts in the device trace (``SpannedTrace``), ms.

In a traced run without marks the breakdown's idle gaps carry the loop
thread's innermost span names (``untraced`` where none is open)."""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

# torch (imported by harness.trace and harness.spans) comes after
# env.set_cache_dirs()
from perfbench.harness import env, main, spec  # noqa: E402

# the metrics that read the spans and counters, each with its unit
SPAN_METRICS = {
    'train.idle_in.data_wait': '%',
    'train.idle_in.pad_upload': '%',
    'train.idle_in.step_host': '%',
    'train.data.build_ms': 'ms',
    'train.data.read_ms': 'ms',
    'train.data.build_cpu_share': '%',
    'train.data.queue_empty_share': '%',
    'train.upload_pageable_mib': 'MiB',
    'train.step_host_ms': 'ms',
}


class SpannedContext(main.Context):
    """The harness's context with the recorder on inside the window."""
    recorder = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans: list = []
        self.counts: Dict[str, int] = {}
        self._recording = False
        SpannedContext.last = self

    def trace_start(self) -> bool:
        from masklab_tpu_torch.utils import profiling
        started = super().trace_start()
        if self.recorder and not self._recording:
            profiling.start_recording()
            self._recording = True
            self._clock()
        return started

    def _clock(self) -> None:
        """In a traced run on a card, a ``clock`` span around a spin
        kernel's launch (``SpannedTrace``'s clock check)."""
        if self.tracer is not None and self.tracer.active and \
                self.device != 'cpu':
            import torch
            from masklab_tpu_torch.utils import profiling
            from perfbench.harness.trace import MARK_CYCLES
            with profiling.span('clock'):
                torch.cuda._sleep(MARK_CYCLES)

    def trace_stop(self) -> None:
        from masklab_tpu_torch.utils import profiling
        if self._recording:
            self._clock()
            self.spans, self.counts = profiling.drain()
            profiling.stop_recording()
            self._recording = False
            if self.tracer is not None:
                self.tracer.spans = self.spans
        super().trace_stop()


def _with_spans(run: Dict) -> Dict:
    ctx = SpannedContext.last
    return dict(run, spans=ctx.spans, program_counts=ctx.counts)


def span_metrics(run: Dict) -> Dict:
    out = {}
    for name, unit in SPAN_METRICS.items():
        value = spec.reader(name)(run)
        if value is not None:
            out[name] = {'value': float(value), 'unit': unit}
    return out


def extras(run: Dict) -> Dict:
    from perfbench.harness import spans
    tr, found = run['trace'], run['spans']
    out = dict(counts=run['program_counts'], spans=len(found),
               data_wait_span_share=spans.data_wait_share(run))
    batches = spans.built_batches(run)
    if batches:
        out['decoded_images_a_batch'] = run['program_counts'].get(
            'data.decoded_images', 0) / len(batches)
    if tr is not None and tr.t1_ns:
        idle = spans.idle_by_span(tr.busy_ns, found, tr.t0_ns, tr.t1_ns)
        out.update(idle_s=idle, window_s=tr.window_s, busy_s=tr.busy_s,
                   idle_share=100.0 * (1 - tr.busy_s / tr.window_s),
                   idle_by_span_share=100.0 * sum(idle.values())
                   / tr.window_s)
    return out


def run(args, bench: Dict, recorder: bool = True, **cell_kwargs):
    """``main.run_cell`` with the recorder on in the window (or off: the
    same harness without it); -> the result with ``span_metrics`` and,
    traced, ``span_extras``, ``e2e_traced``."""
    from perfbench.harness import spans, trace
    kept = {}

    def layer_metrics(bench, cell, run, _orig=main.layer_metrics):
        run = _with_spans(run)
        kept['run'] = run
        return _orig(bench, cell, run)

    saved = main.Context, trace.Trace, main.layer_metrics
    SpannedContext.recorder = recorder
    main.Context, trace.Trace = SpannedContext, spans.SpannedTrace
    main.layer_metrics = layer_metrics
    try:
        out = main.run_cell(args, bench, **cell_kwargs)
    finally:
        main.Context, trace.Trace, main.layer_metrics = saved
    if out is None:
        return None
    # an untraced run reads no layer metrics: its spans alone
    r = kept.get('run') or _with_spans(dict(trace=None, counters={}))
    out['span_metrics'] = span_metrics(r)
    if args.trace:
        out['span_extras'] = extras(r)
        c = r['counters']
        key = ('train_img_per_s' if 'steps' in c else 'frames_per_s')
        if c.get('window_s'):
            out['e2e_traced'] = {key: c['traced_frames'] / c['window_s']}
        if getattr(r['trace'], 'clock', None) is not None:
            out['clock'] = r['trace'].clock
    return out


def parse(argv: List[str]):
    p = argparse.ArgumentParser(prog='perfbench/tools/spans.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=1)
    p.add_argument('--recorder', type=int, choices=(0, 1), default=1)
    return p.parse_args(argv)


def cli(argv: List[str]) -> int:
    args = parse(argv)
    env.set_cache_dirs()
    out = run(args, spec.load_benchmark(), recorder=bool(args.recorder))
    if out is None:
        return 2
    print(f'correct: {out["correct"]}', file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(cli(sys.argv[1:]))
