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
and (in 'visualize' alone) the instance union are reductions of the
full-frame paste (``summary.fused_summary_union``), so only the frame
(uint8) and the table cross to the host. JPEG decode and encode run on the host through cv2,
imported where they are used.

With a ``mesh`` (``parallel.make_mesh``) the predictor keeps one replica
of the model on each device of its ``data`` axis, pads a batch to a
multiple of the axis with zero frames, runs each shard on its replica in a
host thread of its own (each on a CUDA stream of its own, so the shards
overlap on a shared card) and drops the pad rows on the device before the
download. Every image runs the same pipeline alone, so the answers are
those of the unsharded predictor fed the same shards. The JAX predictor's
per-shape jit cache (``max_pipelines``) has no counterpart in eager
PyTorch.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfiguration
from ..device import resolve_device
from ..models.instance import trim_instances
from ..nn.layers import hold_compute_dtype
from ..ops.resize import resize_bilinear, resize_like
from ..utils.profiling import span
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
    makes 'visualize' the default mode, else 'raw'. ``mesh`` (a
    ``parallel.Mesh``) serves over its data axis: ``self.model`` is then
    the tuple of replicas, one a device, and ``device`` is ignored."""

    def __init__(self, model, config: Optional[ModelConfiguration] = None,
                 visualization: bool = False, mesh=None, device=None):
        """``self.model`` is read once a request, so a model (or tuple of
        replicas) swapped in by a ``CheckpointWatcher`` serves the next
        request whole."""
        self.mesh = mesh
        self.config = config or model.config
        self.visualization = visualization
        if mesh is None:
            self.device = resolve_device(device)
            self.model = hold_compute_dtype(model.to(self.device).eval())
            return
        if mesh.shape['model'] != 1:
            raise ValueError(
                f'a mesh of {mesh.shape}: the predictor serves over a data '
                'axis; a model axis splits a train step\'s frames '
                '(parallel.spatial_batch_sharding)')
        self.device = mesh.devices[0]
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        self.model = self._replicas(state)
        self._pool = ThreadPoolExecutor(mesh.size,
                                        thread_name_prefix='mesh-shard')
        self._streams = [torch.cuda.Stream(d) if d.type == 'cuda' else None
                         for d in mesh.devices]

    def _replicas(self, state: Dict[str, torch.Tensor]) -> tuple:
        """One model of this configuration on each mesh device, holding
        ``state`` (a state dict), in inference mode, weights cast once."""
        from ..models.masklab import MaskLab
        out = []
        for d in self.mesh.devices:
            replica = MaskLab(self.config)
            replica.load_state_dict(state)
            out.append(hold_compute_dtype(replica.to(d).eval()))
            if d.type == 'cuda':
                # the shards' streams read the weights this one wrote
                torch.cuda.synchronize(d)
        return tuple(out)

    def place_variables(self, variables) -> torch.nn.Module:
        """A new model of this predictor's configuration holding
        ``variables`` (``train.checkpoints.restore_variables``' form), on
        its device, in inference mode, its weights cast once: ready to be
        swapped in as ``self.model`` (``CheckpointWatcher``); with a mesh,
        the tuple of every replica. The serving model is left alone, so both
        are on the device until the swap."""
        from ..models.masklab import MaskLab
        from ..train.checkpoints import load_variables
        model = load_variables(MaskLab(self.config), variables)
        if self.mesh is not None:
            return self._replicas(model.state_dict())
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
            with span('stage:analytics'):
                summary, union = fused_summary_union(
                    boxes_up, sem_up, masks_up, in_hw,
                    len(post.instance_colors), post.default_road_size,
                    with_union=mode == 'visualize')
            if mode == 'summarize':
                return dict(det_boxes=boxes_up, summarize=summary)
            with span('stage:draw'):
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

        Each stage runs inside a span named ``stage:<name>``
        (``utils.profiling``: kept while recording, a ``record_function``
        in a profiler's trace), so a trace splits a request's time by stage:
        upload, downsample, then ``MaskLab.forward``'s raw_heads, nms and
        mask_branch, then postprocess (with analytics and draw inside it)
        and download."""
        if mode is None:
            mode = 'visualize' if self.visualization else 'raw'
        if images.ndim == 3:
            images = images[None]
        model = self.model
        if self.mesh is None:
            return self._run(model, self.device, images, len(images), mode)
        # each shard's rows; the last one's pad rows are zero frames made
        # on its device, and dropped there before the download
        n = self.mesh.size
        rows = -(-len(images) // n)
        futures = [self._pool.submit(
            self._run_on_stream, model[i], self.mesh.devices[i],
            self._streams[i], images[i * rows:(i + 1) * rows], rows, mode)
            for i in range(n) if i * rows < len(images)]
        shards = [f.result() for f in futures]
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}

    def _run_on_stream(self, model, device, stream, images, rows, mode):
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return self._run(model, device, images, rows, mode)

    def _run(self, model, device, images: np.ndarray, rows: int,
             mode: str) -> Dict[str, np.ndarray]:
        """The pipeline on ``model`` (on ``device``) for ``images``, padded
        with zero frames to ``rows``, the pad rows dropped on the device."""
        keep = len(images)
        with torch.inference_mode():
            with span('stage:upload'):
                x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
                if rows > keep:
                    x = torch.cat([x, x.new_zeros((rows - keep,)
                                                  + x.shape[1:])])
            with span('stage:downsample'):
                down, in_hw, ds_hw = self._downsample(x)
            out = model(down)
            with span('stage:postprocess'):
                out = self._postprocess(out, x, down, in_hw, ds_hw, mode)
            with span('stage:download'):
                return {k: v[:keep].cpu().numpy() for k, v in out.items()}

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
