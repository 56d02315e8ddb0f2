"""The comparison that decides ``correct`` for a served frame.

For each judged frame the program hands over what its timed path made:
the model's input (``down``) and outputs (``cls_pred``, ``loc_pred``,
``roi_boxes``, ``roi_masks``, ``seg_pred``), captured as the forward
returned them, and its answer (the analytics rows). The reference works
the frame out again in float32 from the same raw frame and weights:

  * ``heads_nrmse``: its raw heads (class scores, box regressions,
    semantic map) against the program's, each as ``stats.nrmse``, the
    worst of the three;
  * ``nms_rows_off``: the reference's two-stage NMS run on the program's
    own scores and boxes must pick the program's proposals: the count of
    proposal rows that differ (an exact comparison). Forced-dense scores
    are nearly tied, so which boxes survive follows the scores' last bits;
    the later stages are judged on the program's proposals;
  * ``masks_nrmse``: the reference's mask branch, on its own feature maps
    and the program's proposals, against the program's masks;
  * ``rows_gap``: the analytics rows the reference's postprocess makes
    from the program's own model outputs (proposals, masks, semantic map),
    against the rows the program answered: per column, the summed absolute
    gap over the summed magnitude, the worst column.

The postprocess is judged on the program's own outputs, step by step:
which of a hundred overlapping forced-dense masks takes a pixel, and the
road edges fitted to a semantic map that seeded weights do not make
road-like, follow the last bits of the masks and the map, in the float8
control as much as in the program, so analytics made from the reference's
own masks move by as much for a sound run as for the control. The masks
and the maps themselves are held to the reference by ``masks_nrmse`` and
``heads_nrmse``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..harness.stats import nrmse
from . import pipeline

ROW_TOL = 1e-3       # a proposal row differs where a field is further off


def column_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Column-wise relative L1 gap of two [K, F] analytics tables (the
    rows the program answered, as numbers, and the reference's): per
    column the summed absolute difference over the larger summed
    magnitude; rows present in only one count whole."""
    got = np.asarray(got, np.float64).reshape(-1, want.shape[-1])
    want = np.asarray(want, np.float64)
    n = max(len(got), len(want))
    pad = np.zeros((n, want.shape[-1]))
    g, w = pad.copy(), pad.copy()
    g[:len(got)], w[:len(want)] = got, want
    num = np.abs(g - w).sum(0)
    den = np.maximum(np.abs(w).sum(0), np.abs(g).sum(0))
    return np.where(den > 0, num / np.maximum(den, 1e-30), 0.0)


def rows_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The worst column of ``column_gaps``."""
    return float(np.max(column_gaps(got, want)))


def present_rows(summary: np.ndarray) -> np.ndarray:
    """The rows of a [K, 11] summary that ``summary_to_records`` keeps
    (class >= 0, confidence > 0), in the records' column layout (the
    record's confidence is the row's column 5)."""
    s = np.asarray(summary, np.float64)
    keep = (s[:, 0] >= 0) & (s[:, 5] > 0)
    s = s[keep].copy()
    s[:, 10] = s[:, 10] > 0.5
    return s


def judge_frame(ref_model, cfg, frame: np.ndarray, program: Dict,
                answer_rows: np.ndarray) -> Dict[str, float]:
    """The numbers of one frame. ``program``: the captured model input and
    outputs of this frame (batch dimension 1, on the reference's device);
    ``answer_rows``: the program's analytics rows for the frame as
    ``present_rows`` gives them."""
    dev = program['roi_boxes'].device
    with torch.no_grad(), pipeline.tf32_off():
        images = torch.from_numpy(np.ascontiguousarray(frame))[None].to(dev)
        down, _, _ = pipeline.downsample(images, cfg)
        raw = ref_model.raw_heads(down)
        heads = max(nrmse(program[k], raw[k])
                    for k in ('cls_pred', 'loc_pred', 'seg_pred'))
        props = ref_model.proposals(dict(cls_pred=program['cls_pred'],
                                         loc_pred=program['loc_pred'],
                                         priors=raw['priors']))
        boxes = program['roi_boxes']
        off = int(((props - boxes).abs() > ROW_TOL * (1 + boxes.abs()))
                  .any(-1).sum())
        masks = ref_model.mask_branch(raw['features'], boxes,
                                      raw['image_hw'])
        live = boxes[0, :, 4] >= 0
        masks_err = (nrmse(program['roi_masks'][0, live], masks[0, live])
                     if bool(live.any()) else 0.0)
        post = pipeline.postprocess(program, images, program['down'], cfg)
        want_rows = present_rows(post['summarize'][0].cpu().numpy())
        out = dict(heads_nrmse=heads, nms_rows_off=off,
                   masks_nrmse=masks_err,
                   rows_gap=rows_gap(answer_rows, want_rows),
                   input_gap=float((program['down'] - down).abs().max()))
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the judged frames."""
    keys = sorted({k for r in readings for k in r})
    return {k: max(r[k] for r in readings if k in r) for k in keys}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        passed = (value is not None and limit is not None
                  and np.isfinite(value) and value <= limit)
        ok = ok and passed
        rows.append((name, value, limit))
    return ok, rows
