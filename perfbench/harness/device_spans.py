"""Readers of the device time under the program's own spans: a traced
run's ``Trace.span_busy_s`` (the merged busy time of the kernels inside
each GPU-side annotation of a span's name) over the window's frames."""
from __future__ import annotations

from typing import Dict, Optional


def busy_ms_per_frame(span: str):
    """Device ms a frame under ``span``; None where the trace holds no
    annotation of that name."""
    def read(run: Dict) -> Optional[float]:
        tr, frames = run['trace'], run['counters'].get('traced_frames', 0)
        busy = (getattr(tr, 'span_busy_s', {}).get(span)
                if tr is not None else None)
        if busy is None or not frames:
            return None
        return 1e3 * busy / frames
    return read
