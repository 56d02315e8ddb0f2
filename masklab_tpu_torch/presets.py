"""Configuration presets (the port's own copy of ``masklab_tpu/presets.py``).

``road_project_config`` is the configuration the reference's road project
trains and deploys: the seresnet34 backbone with C3..P6 outputs,
squeeze-excite heads, road-object anchor ratios, min_area 200, and 2-way
data parallelism: the trainer runs one rank on each of two cards where two
are present, and on one card trains alone (``train.trainer``).
"""
from __future__ import annotations

from .config import ModelConfiguration


def road_project_config(data_dir: str = None,
                        save_dir: str = None) -> ModelConfiguration:
    cfg = ModelConfiguration()
    cfg.backbone.backbone_type = 'seresnet34'
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5', 'P6')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    cfg.detection.use_squeeze_excite = True
    cfg.detection.pr_ratios = (1 / 2, 1, 2, 5, 8)
    cfg.instance.use_squeeze_excite = True
    cfg.semantic.use_squeeze_excite = True
    cfg.dataset.min_area = 200.0
    cfg.train.gpu_count = 2
    cfg.compute.mesh_data = 2
    # stage-1 NMS candidate pool of 128 per class for the 5-ratio anchors;
    # the trainer's loss-config NMS keeps the default 256
    cfg.compute.nms_candidates_per_class = 128
    cfg.compute.nms_candidates_per_class_train = 256
    if data_dir is not None:
        cfg.dataset.data_dir = data_dir
    if save_dir is not None:
        cfg.train.save_dir = save_dir
    return cfg
