"""The inference pipeline and its three output modes.

Port of ``MaskLabPredictor`` (``masklab_tpu/serving/predictor.py:42-265``):

  uint8 images -> aspect-preserving downsample -> MaskLab -> NMS -> trim
  -> per-channel semantic smoothing -> resize -> upsample to the original
  resolution -> one of
    * 'visualize': the annotated frame (box borders, the per-class instance
      union and the semantic overlay) and the analytics table;
    * 'summarize': the analytics table alone;
    * any other mode ('raw'): boxes, RoI masks, semantics and the
      full-frame masks.

In 'visualize' and 'summarize' the masks stay on the device: the analytics
and the instance union are reductions of the full-frame paste
(``summary.fused_summary_union``), so only the frame (uint8) and the table
cross to the host. JPEG decode and encode run on the host through cv2,
imported where they are used.

The JAX predictor's ``mesh`` (data-parallel serving over several chips)
is not ported (ROADMAP.md, Queue 1); its per-shape jit cache
(``max_pipelines``) has no counterpart in eager PyTorch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import ModelConfiguration
from ..device import resolve_device
from ..models.instance import trim_instances
from ..nn.layers import hold_compute_dtype
from ..ops.resize import resize_bilinear, resize_like
from .postprocess import crop_and_pad_masks, smooth_semantics, upsample_output
from .summary import fused_summary_union
from .visualize import draw_boxes, draw_segmentation


def _downsampled_hw(in_hw, resolution) -> Tuple[int, int]:
    ratio = min(resolution[0] / in_hw[0], resolution[1] / in_hw[1])
    return int(ratio * in_hw[0]), int(ratio * in_hw[1])


class MaskLabPredictor:
    """Runs the pipeline on ``device`` (CUDA unless the caller asks for the
    CPU) with the model moved there in inference mode, its conv and dense
    weights cast to the compute dtype once (``hold_compute_dtype``: the
    model then serves and no longer trains). ``visualization``
    makes 'visualize' the default mode, else 'raw'. ``mesh`` (serving over
    several cards) is not ported and raises."""

    def __init__(self, model, config: Optional[ModelConfiguration] = None,
                 visualization: bool = False, mesh=None, device=None):
        """``self.model`` is read once a request, so a model swapped in by
        a ``CheckpointWatcher`` serves the next request whole."""
        if mesh is not None:
            raise NotImplementedError(
                'multi-card serving (mesh=) is not ported to PyTorch yet '
                '(ROADMAP.md, Queue 1)')
        self.device = resolve_device(device)
        self.model = hold_compute_dtype(model.to(self.device).eval())
        self.config = config or model.config
        self.visualization = visualization

    def place_variables(self, variables) -> torch.nn.Module:
        """A new model of this predictor's configuration holding
        ``variables`` (``train.checkpoints.restore_variables``' form), on
        its device, in inference mode, its weights cast once: ready to be
        swapped in as ``self.model`` (``CheckpointWatcher``). The serving
        model is left alone, so both are on the device until the swap."""
        from ..models.masklab import MaskLab
        from ..train.checkpoints import load_variables
        model = load_variables(MaskLab(self.config), variables)
        return hold_compute_dtype(model.to(self.device).eval())

    def _downsample(self, images: torch.Tensor):
        """uint8 NHWC frames -> (float frames at the model's resolution,
        input hw, model hw)."""
        in_hw = (images.shape[1], images.shape[2])
        ds_hw = _downsampled_hw(in_hw, self.config.postprocess.resolution)
        down = resize_bilinear(images.float(), ds_hw[0], ds_hw[1],
                               align_corners=True)
        return down, in_hw, ds_hw

    def _postprocess(self, out: Dict[str, torch.Tensor], images: torch.Tensor,
                     down: torch.Tensor, in_hw, ds_hw,
                     mode: str) -> Dict[str, torch.Tensor]:
        """Model outputs -> the mode's outputs at the input resolution."""
        post = self.config.postprocess
        det_boxes, inst_masks = trim_instances(out['roi_boxes'],
                                               out['roi_masks'])
        sem = smooth_semantics(out['seg_pred'], post.smoothing_kernel_sizes,
                               post.smoothing_weights)
        sem = resize_like(sem, down)
        boxes_up, masks_up, sem_up = upsample_output(
            det_boxes, inst_masks, sem, ds_hw, in_hw)
        if mode in ('visualize', 'summarize'):
            with record_function('stage:analytics'):
                summary, union = fused_summary_union(
                    boxes_up, sem_up, masks_up, in_hw,
                    len(post.instance_colors), post.default_road_size)
            if mode == 'summarize':
                return dict(det_boxes=boxes_up, summarize=summary)
            with record_function('stage:draw'):
                vis = draw_boxes(images, boxes_up)
                vis = draw_segmentation(vis, union, post.instance_colors,
                                        post.instance_alpha)
                vis = draw_segmentation(vis, sem_up, post.semantic_colors,
                                        post.semantic_alpha)
            return dict(det_boxes=boxes_up, visualize=vis, summarize=summary)
        padded = crop_and_pad_masks(boxes_up, masks_up, in_hw)
        return dict(det_boxes=boxes_up, instance_masks=masks_up,
                    semantic=sem_up.to(torch.uint8),
                    padded_masks=(padded > 0.5).to(torch.uint8))

    def warmup(self, sizes) -> None:
        """Run the pipeline once per entry of ``sizes``: (h, w) or
        (h, w, batch, mode), on zero frames."""
        for entry in sizes:
            h, w = entry[0], entry[1]
            batch = entry[2] if len(entry) > 2 else 1
            mode = entry[3] if len(entry) > 3 else None
            self.predict(np.zeros((batch, h, w, 3), np.uint8), mode)

    def predict(self, images: np.ndarray,
                mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """images: uint8 [H, W, 3] or [B, H, W, 3] RGB -> numpy outputs.

        ``mode`` None takes the constructor's default. 'visualize' gives
        ``det_boxes`` [B, K, 6] int32 (cx, cy, w, h, class, conf x100),
        ``visualize`` [B, H, W, 3] uint8 and ``summarize`` [B, K + 1, 11]
        float32; 'summarize' ``det_boxes`` and ``summarize``; any other
        mode ``det_boxes``, ``instance_masks`` [B, K, 28, 28] int32,
        ``semantic`` [B, H, W, 3] uint8 and ``padded_masks`` [B, K, H, W]
        uint8.

        Each stage runs inside a ``torch.profiler`` span named
        ``stage:<name>``, so a trace splits a request's time by stage:
        upload, downsample, then ``MaskLab.forward``'s raw_heads, nms and
        mask_branch, then postprocess (with analytics and draw inside it)
        and download."""
        if mode is None:
            mode = 'visualize' if self.visualization else 'raw'
        if images.ndim == 3:
            images = images[None]
        with torch.inference_mode():
            with record_function('stage:upload'):
                x = torch.from_numpy(np.ascontiguousarray(images)).to(
                    self.device)
            with record_function('stage:downsample'):
                down, in_hw, ds_hw = self._downsample(x)
            out = self.model(down)
            with record_function('stage:postprocess'):
                out = self._postprocess(out, x, down, in_hw, ds_hw, mode)
            with record_function('stage:download'):
                return {k: v.cpu().numpy() for k, v in out.items()}

    def predict_bytes(self, content: bytes,
                      mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """JPEG/PNG bytes -> outputs (host decode, device pipeline)."""
        return self.predict(decode_image_bytes(content), mode)

    @staticmethod
    def encode_jpeg(image_rgb: np.ndarray) -> bytes:
        import cv2
        ok, buf = cv2.imencode(
            '.jpg', cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR))
        if not ok:
            raise RuntimeError('jpeg encode failed')
        return bytes(buf.tobytes())


def decode_image_bytes(content: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> uint8 RGB [H, W, 3] (host cv2 decode)."""
    import cv2
    bgr = cv2.imdecode(np.frombuffer(content, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError('could not decode image bytes '
                         '(corrupt or unsupported format)')
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def summary_to_records(summary_row: np.ndarray, instance_labels,
                       crack_label: str = 'crack'):
    """[K, 11] analytics rows -> list of dicts, one per present instance
    (class >= 0 and confidence > 0)."""
    names = list(instance_labels) + [crack_label]
    records = []
    for row in summary_row:
        cls = int(row[0])
        if cls < 0 or row[5] <= 0:
            continue
        records.append({
            'name': names[cls] if cls < len(names) else str(cls),
            'x': float(row[1]), 'y': float(row[2]),
            'w': float(row[3]), 'h': float(row[4]),
            'confidence': float(row[5]),
            'pixelSize': float(row[6]),
            'estimatedSize': float(row[7]),
            'estimatedHorizontalLength': float(row[8]),
            'estimatedVerticalLength': float(row[9]),
            'includeMyRoad': bool(row[10] > 0.5),
        })
    return records
