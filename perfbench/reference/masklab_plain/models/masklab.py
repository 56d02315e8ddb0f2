"""MaskLab: joint RetinaMask detection/instance + DeepLab V3+ semantic model.

Port of ``masklab_tpu/models/masklab.py`` (``raw_heads`` :138-164,
``mask_branch`` :166-185, ``__call__`` :189-207, ``trainer_outputs``
:209-244): shared backbone, FPN, cls/loc heads, detection-config NMS, the
routed mask branch and the semantic head, with squeeze-excite heads (the
road preset) where the configuration asks for them, over a seresnet34,
resnet50 or efficientnet b2 / b3 / b4 body. Separable heads, the
fused mask head and the recomputed backbone, which no configuration of the
benchmark runs, raise. The BatchNorm mode is
the module's: ``model.train()`` for the reference's ``train=True``.
Public outputs keep the reference's layouts: NHWC images in, ``cls_pred``
[B, N, C], ``roi_boxes`` [B, K, 6], ``roi_masks`` [B, K, 28, 28, C] and
``seg_pred`` [B, H/8, W/8, 3] out.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfiguration
from ..nn.backbone import BackboneNetwork, backbone_channels
from ..ops.boxes import decode_boxes
from ..ops.nms import batched_class_aware_nms
from ..prior import generate_priors, priors_from_config
from .detection import BoxRegressionSubNet, ClassificationSubNet, FeaturePyramid
from .instance import MaskSubNet, mask_distribute
from .semantic import ASPPNetwork, SegmentationSubNet


class MaskLab(nn.Module):
    def __init__(self, config: ModelConfiguration):
        super().__init__()
        cfg = self.config = config
        if (cfg.compute.fused_mask_head or cfg.compute.remat_backbone
                or cfg.detection.use_separable_conv
                or cfg.instance.use_separable_conv
                or cfg.semantic.use_separable_conv):
            raise NotImplementedError(
                'the plain reference runs neither separable heads, the '
                'fused mask head nor a recomputed backbone')
        self.dtype = (torch.bfloat16
                      if cfg.compute.compute_dtype == 'bfloat16'
                      else torch.float32)
        outputs = tuple(cfg.backbone.backbone_outputs)
        strides = [2 ** int(n[-1]) for n in outputs]
        if strides != sorted(strides):
            raise ValueError('backbone_outputs must be in ascending-stride '
                             f'order, got {outputs}')
        fpn_inputs = cfg.detection.feature_pyramid_inputs
        self.fpn_names = [n for n in outputs if n in fpn_inputs]
        self.other_names = [n for n in outputs if n not in fpn_inputs]
        fpn_strides = [2 ** int(n[-1]) for n in self.fpn_names]
        other_strides = [2 ** int(n[-1]) for n in self.other_names]
        if fpn_strides and other_strides \
                and min(other_strides) < max(fpn_strides):
            raise ValueError(
                'every backbone output outside feature_pyramid_inputs must '
                'have a higher stride than the FPN inputs; got outputs '
                f'{outputs} with FPN inputs {fpn_inputs}')
        self.prior = priors_from_config(cfg)
        self._prior_cache = {}          # (h, w, device) -> [N, 4] priors
        dtype = self.dtype
        num_det = len(cfg.dataset.instance_labels)
        num_seg = len(cfg.dataset.semantic_labels)
        self.backbone = BackboneNetwork(cfg.backbone.backbone_type, outputs,
                                        cfg.backbone.num_features, dtype)

        body_channels = backbone_channels(cfg.backbone.backbone_type)

        def channels(name):
            if name.startswith('P'):
                return cfg.backbone.num_features
            return body_channels[name]

        det, ins, sem = cfg.detection, cfg.instance, cfg.semantic
        self.fpn = FeaturePyramid([channels(n) for n in self.fpn_names],
                                  det.num_features, dtype)
        feat_ch = ([det.num_features] * len(self.fpn_names)
                   + [channels(n) for n in self.other_names])
        common = dict(num_depth=det.num_depth, num_features=det.num_features,
                      num_priors=len(self.prior), groups=det.groups,
                      dtype=dtype, squeeze_ratio=det.squeeze_ratio)
        self.cls_subnet = ClassificationSubNet(
            feat_ch, num_det, use_squeeze_excite=det.use_squeeze_excite,
            **common)
        # the reference's quirk, kept: the box head's squeeze-excite follows
        # use_separable_conv (masklab_tpu/models/masklab.py:97-101), so the
        # road preset's box head has none
        self.loc_subnet = BoxRegressionSubNet(
            feat_ch, use_squeeze_excite=False, **common)
        self.mask_subnet = MaskSubNet(feat_ch[:ins.max_k + 1], num_det,
                                      ins.num_depth, ins.num_features,
                                      ins.groups, dtype,
                                      ins.use_squeeze_excite,
                                      ins.squeeze_ratio)
        self.aspp = ASPPNetwork(channels(sem.aspp_input_name),
                                sem.num_aspp_features, sem.atrous_rate,
                                sem.atrous_groups, dtype)
        self.seg_subnet = SegmentationSubNet(
            sem.num_aspp_features, channels(sem.skip_input_name), num_seg,
            sem.num_depth, sem.num_features, sem.num_skip_features,
            sem.groups, dtype, sem.use_squeeze_excite, sem.squeeze_ratio)

    def _priors(self, h: int, w: int, device: torch.device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._prior_cache:
            with torch.inference_mode(False):    # usable by a train step too
                self._prior_cache[key] = torch.from_numpy(generate_priors(
                    h, w, self.prior, padding='same')).to(device)
        return self._prior_cache[key]

    def raw_heads(self, images: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> Dict:
        """Backbone -> FPN -> cls/loc heads + ASPP/decoder + priors.
        ``generator`` is handed to the backbone (neither body draws from
        it)."""
        cfg = self.config
        images = images.float()
        endpoints = self.backbone(images, generator)
        fpn_outputs = self.fpn([endpoints[n] for n in self.fpn_names])
        features = fpn_outputs + [endpoints[n] for n in self.other_names]
        cls_pred = self.cls_subnet(features).float()
        loc_pred = self.loc_subnet(features).float()
        aspp_out = self.aspp(endpoints[cfg.semantic.aspp_input_name])
        seg = self.seg_subnet(aspp_out,
                              endpoints[cfg.semantic.skip_input_name])
        seg_pred = seg.permute(0, 2, 3, 1).float()
        h, w = images.shape[1], images.shape[2]
        return dict(cls_pred=cls_pred, loc_pred=loc_pred, features=features,
                    seg_pred=seg_pred, priors=self._priors(h, w,
                                                           images.device),
                    image_hw=(h, w))

    def mask_branch(self, features, boxes: torch.Tensor,
                    image_hw) -> torch.Tensor:
        """boxes [B, K, >=6] -> masks [B, K, 2ch, 2cw, num_det_classes]."""
        ins = self.config.instance
        levels = mask_distribute(boxes, ins.max_k, ins.base_size)
        return self.mask_subnet(features[:ins.max_k + 1], boxes, levels,
                                image_hw, tuple(ins.crop_size))

    def proposals(self, out: Dict) -> torch.Tensor:
        """Decode + detection-config NMS of ``raw_heads`` outputs ->
        [B, nms_max_output_size, 6] rows, -1-padded."""
        cfg = self.config
        det = cfg.detection
        return batched_class_aware_nms(
            out['cls_pred'], decode_boxes(out['loc_pred'], out['priors']),
            min_confidence=det.min_confidence,
            nms_iou_threshold=det.nms_iou_threshold,
            post_iou_threshold=det.post_iou_threshold,
            max_outputs=det.nms_max_output_size,
            candidates_per_class=cfg.compute.nms_candidates_per_class)

    def trainer_outputs(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                        with_metrics: bool = True,
                        generator: Optional[torch.Generator] = None,
                        proposals: Optional[torch.Tensor] = None) -> Dict:
        """Trainer path: ``raw_heads``, then the loss-config NMS proposals
        behind the gt boxes feed the mask branch. The NMS runs on detached
        scores and boxes (the reference stops their gradient), so gradients
        reach the feature maps through the mask crops alone. With
        ``with_metrics`` also ``metric_proposals``, the detection-config NMS
        of the metric branch; without, it is not computed. ``generator``:
        as ``raw_heads``. ``proposals``: another run's loss-NMS proposals,
        taken in place of this one's (its decisions replayed)."""
        cfg = self.config
        out = self.raw_heads(images, generator)
        lc = cfg.loss
        with torch.no_grad():
            own = batched_class_aware_nms(
                out['cls_pred'], decode_boxes(out['loc_pred'], out['priors']),
                min_confidence=lc.min_confidence,
                nms_iou_threshold=lc.nms_iou_threshold,
                post_iou_threshold=lc.post_iou_threshold,
                max_outputs=lc.nms_max_output_size,
                candidates_per_class=(cfg.compute.nms_candidates_per_class_train
                                      or cfg.compute.nms_candidates_per_class))
            out['own_proposals'] = own
            if proposals is None:
                proposals = own
            if with_metrics:
                out['metric_proposals'] = self.proposals(out)
        chosen = torch.cat([gt_boxes.float(), proposals], dim=1)
        out.update(roi_boxes=chosen,
                   roi_masks=self.mask_branch(out['features'], chosen,
                                              out['image_hw']))
        return out

    def forward(self, images: torch.Tensor) -> Dict:
        """Inference: raw heads -> detection-config NMS -> masks.
        images: NHWC [B, H, W, 3] in [0, 255]."""
        out = self.raw_heads(images)
        proposals = self.proposals(out)
        roi_masks = self.mask_branch(out['features'], proposals,
                                     out['image_hw'])
        return dict(cls_pred=out['cls_pred'], loc_pred=out['loc_pred'],
                    roi_boxes=proposals, roi_masks=roi_masks,
                    seg_pred=out['seg_pred'], priors=out['priors'])

