"""The precision control: the plain reference put in the program's place,
computed in float8 e4m3 (``pipeline.to_fp8_control``), the precision
below the configurations' bfloat16. It runs the served pipeline on the
judged frames (its own raw heads, NMS, mask branch and postprocess) and
is judged as the program is; a sound limit is one the control fails."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import judge, pipeline


def control_numbers(model_dict: Dict, state: Dict[str, torch.Tensor],
                    frames: List[np.ndarray], device) -> Dict[str, float]:
    """The worst reading of each number over ``frames``."""
    cfg = pipeline.config(model_dict)
    ref = pipeline.build(model_dict, state, device)
    ctrl = pipeline.to_fp8_control(pipeline.build(model_dict, state, device))
    readings = []
    for frame in frames:
        with torch.no_grad(), pipeline.tf32_off():
            images = torch.from_numpy(np.ascontiguousarray(frame))[None].to(
                device)
            down, _, _ = pipeline.downsample(images, cfg)
            raw = ctrl.raw_heads(down)
            boxes = ctrl.proposals(raw)
            masks = ctrl.mask_branch(raw['features'], boxes, raw['image_hw'])
            program = dict(down=down, cls_pred=raw['cls_pred'],
                           loc_pred=raw['loc_pred'], seg_pred=raw['seg_pred'],
                           roi_boxes=boxes, roi_masks=masks)
            post = pipeline.postprocess(
                dict(roi_boxes=boxes, roi_masks=masks,
                     seg_pred=raw['seg_pred']), images, down, cfg)
        rows = judge.present_rows(post['summarize'][0].cpu().numpy())
        readings.append(judge.judge_frame(ref, cfg, frame, program, rows))
    return judge.worst(readings)
