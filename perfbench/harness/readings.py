"""What the per-layer metrics' readers (``metrics/<metric>.py``) compute
from a traced run. ``run`` holds: ``trace`` (``harness.trace.Trace`` or
None), ``counters`` (the driver's), ``roofline`` (each kernel's share),
``flops_per_frame`` (the reference's count of a forward) and
``peak_bytes``. Each returns None where the run holds nothing to read."""
from __future__ import annotations

from typing import Dict, Optional

from ..reference.roofline import H100_BF16_FLOPS


def _per_frame_ms(run: Dict, stages) -> Optional[float]:
    tr, frames = run['trace'], run['counters'].get('traced_frames', 0)
    if tr is None or not frames or not any(s in tr.stage_busy_s
                                           for s in stages):
        return None
    return 1e3 * sum(tr.stage_busy_s.get(s, 0.0) for s in stages) / frames


def forward_busy_ms_per_frame(run: Dict) -> Optional[float]:
    """Device time of the model's forward (raw heads, NMS, mask branch) a
    frame, over the traced window's frames."""
    return _per_frame_ms(run, ('forward',))


def post_busy_ms_per_frame(run: Dict) -> Optional[float]:
    """Device time of the postprocess (analytics and drawing; not the
    download's copies) a frame."""
    return _per_frame_ms(run, ('postprocess',))


def roofline(kernel: str):
    def read(run: Dict) -> Optional[float]:
        return run['roofline'].get(kernel)
    return read


def idle_share(run: Dict) -> Optional[float]:
    """Share of the traced window in which no device operation ran, %."""
    tr = run['trace']
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(run: Dict) -> Optional[float]:
    """The reference's operation count of the traced window's work (a
    frame's forward times the frames served, or the driver's own sum:
    forward and backward of each train step at its shapes), over the
    window, against the H100's 989 TFLOP/s in bfloat16, %."""
    tr, c = run['trace'], run['counters']
    flops = c.get('flops') or run['flops_per_frame'] * c.get(
        'traced_frames', 0)
    if tr is None or not flops or tr.window_s <= 0:
        return None
    return 100.0 * flops / tr.window_s / H100_BF16_FLOPS


def share_of_window(key: str):
    """100 x the counter ``key`` (seconds) over the window's."""
    def read(run: Dict) -> Optional[float]:
        c = run['counters']
        if key not in c or not c.get('window_s'):
            return None
        return 100.0 * c[key] / c['window_s']
    return read


def per_second_of_window(key: str):
    """The counter ``key`` over the window's seconds."""
    def read(run: Dict) -> Optional[float]:
        c = run['counters']
        if key not in c or not c.get('window_s'):
            return None
        return c[key] / c['window_s']
    return read


def busy_ms_per(key: str):
    """The traced window's device busy ms over the counter ``key``."""
    def read(run: Dict) -> Optional[float]:
        tr, n = run['trace'], run['counters'].get(key)
        if tr is None or not n or tr.busy_s <= 0:
            return None
        return 1e3 * tr.busy_s / n
    return read


def peak_gib(run: Dict) -> Optional[float]:
    """``torch.cuda.max_memory_allocated()`` up to the window's end, GiB."""
    return run['peak_bytes'] / 2 ** 30 if run['peak_bytes'] else None


def counter_mean_ms(key: str):
    def read(run: Dict) -> Optional[float]:
        values = run['counters'].get(key) or []
        return 1e3 * sum(values) / len(values) if values else None
    return read
