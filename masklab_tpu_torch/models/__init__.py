"""Model assembly: detection / instance / semantic paths and MaskLab."""
from .detection import BoxRegressionSubNet, ClassificationSubNet, FeaturePyramid
from .fused_mask_head import FusedMaskSubNet
from .instance import MaskSubNet, mask_distribute, trim_instances
from .masklab import MaskLab, build_masklab
from .semantic import ASPPNetwork, SegmentationSubNet

__all__ = [
    'FeaturePyramid', 'ClassificationSubNet', 'BoxRegressionSubNet',
    'MaskSubNet', 'FusedMaskSubNet', 'mask_distribute', 'trim_instances',
    'ASPPNetwork', 'SegmentationSubNet', 'MaskLab', 'build_masklab',
]
