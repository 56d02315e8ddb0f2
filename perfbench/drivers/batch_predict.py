"""Analytics over stored video: a closed loop of
``MaskLabPredictor.predict(frames, mode)`` on batches of decoded uint8
frames, cycling a few distinct batches drawn from the seed. No HTTP, no
JPEG, no batcher: the model forward and the mode's postprocess.

Traffic parameters: ``mode``, ``frame_hw``, ``batch``,
``distinct_batches``, ``noise`` (the frames' sensor noise), ``judged``
(frames judged, drawn from the seed), ``warmup_calls``."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..harness import frames
from ..reference.judge import present_rows
from .capture import Capture


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.judged_answers: Dict = {}

    def setup(self) -> None:
        from masklab_tpu_torch.models.masklab import MaskLab
        from masklab_tpu_torch.serving.predictor import MaskLabPredictor
        ctx, t = self.ctx, self.t
        cfg = ctx.port_config()
        model = MaskLab(cfg)
        model.load_state_dict(ctx.weights())
        self.predictor = MaskLabPredictor(model, cfg, device=ctx.device)
        rng = np.random.default_rng(ctx.seed)
        hw = tuple(t['frame_hw'])
        self.batches = [np.stack([frames.road_frame(rng, hw, t['noise'])
                                  for _ in range(t['batch'])])
                        for _ in range(t['distinct_batches'])]
        picks = rng.choice(t['distinct_batches'] * t['batch'], t['judged'],
                           replace=False)
        self.judge_rows: Dict[int, List[int]] = {}
        for p in sorted(int(p) for p in picks):
            self.judge_rows.setdefault(p // t['batch'], []).append(
                p % t['batch'])
        self.capture = Capture(self.predictor.model, ctx.mark)
        for i in range(t['warmup_calls']):
            self.predictor.predict(self.batches[i % len(self.batches)],
                                   t['mode'])
        ctx.synchronize()

    def window(self) -> Dict:
        ctx, t = self.ctx, self.t
        calls = frames_done = 0
        captured = {}
        ctx.trace_start()
        start = time.perf_counter()
        while True:
            b = calls % len(self.batches)
            self.capture.rows = self.judge_rows.get(b)
            ctx.mark('call')
            out = self.predictor.predict(self.batches[b], t['mode'])
            ctx.mark('call_end')
            calls += 1
            frames_done += t['batch']
            if self.capture.rows:
                captured[b] = (self.capture.last, out['summarize'])
            elapsed = time.perf_counter() - start
            if elapsed >= ctx.seconds:
                break
        ctx.trace_stop()
        self.capture.remove()
        self.captured = captured
        return dict(attempted=frames_done, failed=0,
                    e2e={'frames_per_s': frames_done / elapsed},
                    counters=dict(calls=calls, window_s=elapsed,
                                  traced_frames=frames_done))

    def judged(self) -> List[Dict]:
        """Each judged frame with what the timed path made for it (the
        last call of its batch); ``program`` None where nothing was
        captured."""
        out = []
        for b, rows in sorted(self.judge_rows.items()):
            tensors, summary = self.captured.get(b, ({}, None))
            for r in rows:
                got = tensors.get(r) is not None and r < len(summary)
                out.append(dict(frame=self.batches[b][r],
                                program=tensors.get(r) if got else None,
                                rows=present_rows(summary[r]) if got else None))
        return out

    def close(self) -> None:
        self.predictor = None
