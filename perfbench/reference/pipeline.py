"""The plain reference pipeline: the configuration's model in float32 with
TF32 off, the predictor's downsample and postprocess, a precision control,
and the operation counts of a forward.

The model and the postprocess are ``masklab_plain``, the frozen stand-alone
copy of the program's plain paths; the steps around them are copies of
``MaskLabPredictor._downsample`` / ``_postprocess``. Nothing here imports
the program."""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Tuple

import torch
from torch import nn

from .masklab_plain.config import ModelConfiguration
from .masklab_plain.models.instance import trim_instances
from .masklab_plain.models.masklab import MaskLab
from .masklab_plain.ops.resize import resize_bilinear, resize_like
from .masklab_plain.serving.postprocess import (smooth_semantics,
                                                upsample_output)
from .masklab_plain.serving.summary import fused_summary_union

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def config(model_dict: Dict, dtype: str = 'float32') -> ModelConfiguration:
    """The reference's configuration: the cell's, computed in ``dtype``."""
    cfg = ModelConfiguration().from_dict(copy.deepcopy(model_dict))
    cfg.compute.compute_dtype = dtype
    return cfg


@contextlib.contextmanager
def tf32_off():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build(model_dict: Dict, state: Dict[str, torch.Tensor],
          device) -> MaskLab:
    """The reference model holding ``state`` (the benchmark's weights), in
    inference mode, float32."""
    model = MaskLab(config(model_dict))
    model.load_state_dict(state)
    return model.to(device).eval()


def _downsampled_hw(in_hw, resolution) -> Tuple[int, int]:
    ratio = min(resolution[0] / in_hw[0], resolution[1] / in_hw[1])
    return int(ratio * in_hw[0]), int(ratio * in_hw[1])


def downsample(images: torch.Tensor, cfg: ModelConfiguration):
    """uint8 NHWC frames -> (float frames at the model's resolution, input
    hw, model hw)."""
    in_hw = (images.shape[1], images.shape[2])
    ds_hw = _downsampled_hw(in_hw, cfg.postprocess.resolution)
    down = resize_bilinear(images.float(), ds_hw[0], ds_hw[1],
                           align_corners=True)
    return down, in_hw, ds_hw


def postprocess(out: Dict[str, torch.Tensor], images: torch.Tensor,
                down: torch.Tensor,
                cfg: ModelConfiguration) -> Dict[str, torch.Tensor]:
    """Model outputs (``roi_boxes``, ``roi_masks``, ``seg_pred``) -> the
    summarize mode's outputs at the input resolution, as the predictor's."""
    post = cfg.postprocess
    in_hw = (images.shape[1], images.shape[2])
    ds_hw = (down.shape[1], down.shape[2])
    det_boxes, inst_masks = trim_instances(out['roi_boxes'], out['roi_masks'])
    sem = smooth_semantics(out['seg_pred'], post.smoothing_kernel_sizes,
                           post.smoothing_weights)
    sem = resize_like(sem, down)
    boxes_up, masks_up, sem_up = upsample_output(
        det_boxes, inst_masks, sem, ds_hw, in_hw)
    summary, _ = fused_summary_union(
        boxes_up, sem_up, masks_up, in_hw, len(post.instance_colors),
        post.default_road_size)
    return dict(det_boxes=boxes_up, summarize=summary)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude at the format's largest value), back in ``t``'s dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(t.dtype)


def to_fp8_control(model: nn.Module) -> nn.Module:
    """The precision control: every conv, transposed conv and dense layer
    takes its weight and its input rounded to float8 e4m3 (per-tensor
    scales) and accumulates in float32, the next precision below the
    configuration's bfloat16. In place; returns ``model``."""
    def round_input(module, args):
        return (_fp8(args[0]),) + tuple(args[1:])
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.copy_(_fp8(m.weight))
                m.register_forward_pre_hook(round_input)
    return model


def forward_flops(model_dict: Dict, model_hw: Tuple[int, int],
                  rois: int = None) -> Dict:
    """Multiply-adds x 2 of one frame's forward at the model's input size,
    counted on the 'meta' device (no data): every conv, transposed conv
    and dense layer of ``raw_heads`` at ``model_hw``, and the mask heads
    over ``rois`` boxes (default ``nms_max_output_size``: the forced-dense
    regime fills every slot; every level's head has the same widths).
    Returns ``{'raw_heads', 'mask_heads', 'forward'}``."""
    cfg = config(model_dict)
    with torch.device('meta'):
        model = MaskLab(cfg).eval()
    counts = []

    def count(module, args, out):
        if isinstance(module, nn.ConvTranspose2d):
            x = args[0]
            k = math.prod(module.kernel_size)
            counts.append(2 * x.numel() // x.shape[1] * module.in_channels
                          * module.out_channels // module.groups * k)
        elif isinstance(module, nn.Conv2d):
            k = math.prod(module.kernel_size)
            counts.append(2 * out.numel() * module.in_channels
                          // module.groups * k)
        else:
            counts.append(2 * out.numel() * module.in_features)
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    h, w = model_hw
    with torch.no_grad():
        model.raw_heads(torch.zeros((1, h, w, 3), device='meta'))
        raw = sum(counts)
        counts.clear()
        head = model.mask_subnet.level_0
        ch, cw = cfg.instance.crop_size
        head(torch.zeros((1, cfg.detection.num_features, ch, cw),
                         device='meta'))
        mask = sum(counts) * (rois or cfg.detection.nms_max_output_size)
    for hook in hooks:
        hook.remove()
    return dict(raw_heads=raw, mask_heads=mask, forward=raw + mask)

