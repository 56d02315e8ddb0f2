"""Hierarchical model configuration (the port's own copy).

A field-for-field copy of ``masklab_tpu/config.py``, kept here so that the
PyTorch port imports nothing of the JAX package. Configurations saved by
either package load in the other. The ``compute`` group's layout knobs
(capacity ladder, mesh axes) are accepted and ignored here; ``MaskLab``
refuses ``remat_backbone`` and ``fused_mask_head``, which the plain
reference does not run.

Re-design of the reference's ``ModelConfiguration``
(the reference engine/config.py:10-248): eight nested attribute groups with
dict/JSON round-trip, per-key ``update``, and an auto-generated argparse CLI
with ``-group.attr`` flags (including ``nargs='+'`` handling for sequences).

Differences from the reference (deliberate, documented):
  * implemented as dataclasses (immutable-by-convention, copyable) instead of
    mutable class-attribute namespaces;
  * adds a ``compute`` group (dtype, static resolution buckets, detection
    slot sizes) that the reference's dynamic-shape TF-1 graphs did not
    need.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tuple_field(*values):
    return field(default_factory=lambda: tuple(values))


def _list_field(*values):
    return field(default_factory=lambda: list(values))


@dataclass
class PostProcessConfig:
    """Output-correction parameters (reference engine/config.py:11-45)."""
    resolution: Tuple[int, int] = (540, 960)
    min_confidence: float = 0.3
    nms_iou_threshold: float = 0.4
    post_iou_threshold: float = 0.6
    nms_max_output_size: int = 100
    smoothing_kernel_sizes: Tuple[int, ...] = (0, 0, 0)
    smoothing_weights: Tuple[float, ...] = (1.0, 1.0, 1.0)
    instance_colors: List[List[int]] = _list_field(
        [192, 32, 128], [160, 96, 0], [96, 0, 128], [32, 96, 192], [96, 32, 128])
    instance_alpha: float = 0.3
    semantic_colors: List[List[int]] = _list_field(
        [64, 0, 128], [128, 96, 0], [128, 192, 0])
    semantic_alpha: float = 0.3
    default_road_size: float = 3.25


@dataclass
class BackBoneConfig:
    """Backbone hyperparameters (reference engine/config.py:47-53)."""
    backbone_type: str = 'resnet50'
    num_features: int = 128
    backbone_outputs: Tuple[str, ...] = ('C3', 'C4', 'C5', 'P6', 'P7')


@dataclass
class DetectionConfig:
    """Detection hyperparameters (reference engine/config.py:55-76)."""
    pr_scales: Tuple[float, ...] = (2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3))
    pr_ratios: Tuple[float, ...] = (1 / 3, 1 / 2, 1, 2, 3)
    feature_pyramid_inputs: Tuple[str, ...] = ('C3', 'C4', 'C5')
    num_features: int = 128
    num_depth: int = 4
    use_separable_conv: bool = False
    expand_ratio: float = 4.0
    use_squeeze_excite: bool = False
    squeeze_ratio: int = 16
    groups: int = 16
    min_confidence: float = 0.5
    nms_iou_threshold: float = 0.4
    post_iou_threshold: float = 0.6
    nms_max_output_size: int = 100


@dataclass
class InstanceConfig:
    """Instance-mask hyperparameters (reference engine/config.py:78-95)."""
    max_k: int = 2
    base_size: int = 36
    crop_size: Tuple[int, int] = (14, 14)
    num_features: int = 128
    num_depth: int = 4
    use_separable_conv: bool = False
    expand_ratio: float = 4.0
    use_squeeze_excite: bool = False
    squeeze_ratio: int = 16
    groups: int = 16


@dataclass
class SemanticConfig:
    """Semantic-segmentation hyperparameters (reference engine/config.py:97-116)."""
    num_aspp_features: int = 128
    atrous_rate: Tuple[int, ...] = (6, 12, 18)
    atrous_groups: int = 16
    skip_input_name: str = 'C3'
    aspp_input_name: str = 'C5'
    num_features: int = 128
    num_skip_features: int = 32
    num_depth: int = 4
    use_separable_conv: bool = False
    expand_ratio: float = 4.0
    use_squeeze_excite: bool = False
    squeeze_ratio: int = 16
    groups: int = 16


@dataclass
class LossConfig:
    """Loss hyperparameters (reference engine/config.py:118-140)."""
    cls_loss_weight: float = 300.0
    cls_loss_alpha: float = 0.25
    cls_loss_gamma: float = 2.0
    box_loss_weight: float = 1.0
    box_loss_momentum: float = 0.9
    box_loss_beta: float = 0.11
    box_loss_use_adjust: bool = True
    mask_loss_weight: float = 1e-2
    mask_loss_label_smoothing: float = 0.0
    seg_loss_weight: float = 0.5
    seg_loss_label_smoothing: float = 0.0
    min_confidence: float = 5e-2
    nms_iou_threshold: float = 0.6
    post_iou_threshold: float = 0.8
    nms_max_output_size: int = 100


@dataclass
class DatasetConfig:
    """Dataset hyperparameters (reference engine/config.py:142-154)."""
    train_cases: List[str] = field(default_factory=list)
    valid_cases: List[str] = field(default_factory=list)
    min_area: float = 1000.0
    instance_labels: Tuple[str, ...] = ('car', 'bump', 'manhole', 'steel', 'pothole')
    semantic_labels: Tuple[str, ...] = ('other_road', 'my_road', 'crack')
    except_semantic_labels: Tuple[str, ...] = ('car',)
    data_dir: str = os.path.join(ROOT_DIR, 'datasets/')


@dataclass
class TrainConfig:
    """Training hyperparameters (reference engine/config.py:156-188).

    ``gpu_count`` is kept for CLI compatibility but maps onto the size of the
    ``data`` mesh axis (see masklab_tpu/parallel).
    """
    save_dir: str = os.path.join(ROOT_DIR, 'logs/')
    # base RNG seed for the run: dropout/drop-connect noise, generator
    # shuffling, and worker-side epoch shuffles all derive from it
    # (no reference counterpart — TF1 used graph-level nondeterminism)
    seed: int = 42
    gpu_count: int = 2
    use_multiprocessing: bool = True
    # worker processes for batch building (fit_generator's worker pool,
    # engine/train.py:106-109). 0 = in-process thread prefetch, the right
    # default on few-core hosts; >0 requires use_multiprocessing.
    data_workers: int = 0
    batch_size: int = 8
    max_batch_size: int = 32
    inference_batch_size: int = 1
    scale_ratio: Tuple[float, float] = (0.4, 0.6)
    train_head_tune: bool = True
    train_head_level: str = 'C5'
    train_head_tune_epoch: int = 10
    head_base_lr: float = 1e-4
    head_max_lr: float = 1e-3
    head_step_size: int = 700
    train_waist_tune: bool = True
    train_waist_level: str = 'C2'
    train_waist_tune_epoch: int = 10
    waist_base_lr: float = 1e-4
    waist_max_lr: float = 1e-3
    waist_step_size: int = 700
    train_all: bool = True
    train_all_epoch: int = 30
    all_base_lr: float = 1e-5
    all_max_lr: float = 1e-4
    all_step_size: int = 700


@dataclass
class ComputeConfig:
    """Compute knobs with no reference counterpart: dtype, the static
    detection slot sizes and the train-time resolution buckets."""
    # dtype for backbone/head convolutions ('float32' or 'bfloat16').
    compute_dtype: str = 'float32'
    # number of candidate boxes per class entering per-class NMS
    # (the reference considered *every* anchor above min_confidence;
    # a fixed-size top-k pool is the static-shape equivalent).
    nms_candidates_per_class: int = 256
    # pool for the TRAINER's loss-config proposal NMS (its min_confidence
    # floor is ~0.05, so mid-training score distributions can clear it on
    # far more anchors than detection-threshold inference ever sees).
    # 0 = inherit nms_candidates_per_class. Lets a preset trim the
    # inference pool without touching training proposals.
    nms_candidates_per_class_train: int = 0
    # static train-time scale buckets replacing the reference's continuous
    # random scale in (0.4, 0.6) (engine/utils/generator/masklab.py:52-62).
    scale_buckets: Tuple[float, ...] = (0.4, 0.45, 0.5, 0.55, 0.6)
    # The layout knobs (mesh axes, remat, fused mask head, capacity-bucketed
    # mask compaction) are kept so that configurations load unchanged; the
    # mask branch runs each level's head on exactly that level's boxes.
    mesh_data: int = 1
    mesh_model: int = 1
    remat_backbone: bool = False
    fused_mask_head: bool = False
    mask_compaction: bool = True
    mask_capacity_fractions: Tuple[float, ...] = (0.03125, 0.0625, 0.08,
                                                  0.125, 0.16, 0.25, 0.33,
                                                  0.4, 0.5, 0.75, 0.8,
                                                  0.875, 0.9, 1.0)


_GROUP_TYPES = {
    'postprocess': PostProcessConfig,
    'backbone': BackBoneConfig,
    'detection': DetectionConfig,
    'instance': InstanceConfig,
    'semantic': SemanticConfig,
    'loss': LossConfig,
    'dataset': DatasetConfig,
    'train': TrainConfig,
    'compute': ComputeConfig,
}


@dataclass
class ModelConfiguration:
    """Root configuration: eight reference groups plus ``compute``."""
    postprocess: PostProcessConfig = field(default_factory=PostProcessConfig)
    backbone: BackBoneConfig = field(default_factory=BackBoneConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    instance: InstanceConfig = field(default_factory=InstanceConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)

    # --- dict / JSON round-trip (reference config.py:190-209) ---
    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for group in _GROUP_TYPES:
            out[group] = dict(dataclasses.asdict(getattr(self, group)))
        return out

    def from_dict(self, config_dict: Dict[str, Dict[str, Any]]) -> 'ModelConfiguration':
        for group, attrs in config_dict.items():
            if group not in _GROUP_TYPES:
                continue
            target = getattr(self, group)
            for key, value in attrs.items():
                if hasattr(target, key):
                    setattr(target, key, _coerce_like(getattr(target, key), value))
        return self

    def update(self, attr_group: str, key: str, value: Any) -> None:
        target = getattr(self, attr_group)
        setattr(target, key, _coerce_like(getattr(target, key), value))

    def save_json(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)

    @classmethod
    def load_json(cls, path: str) -> 'ModelConfiguration':
        with open(path) as f:
            return cls().from_dict(json.load(f))

    # --- argparse CLI (reference config.py:211-235) ---
    def get_arg_parser(self, default_config: 'ModelConfiguration' = None,
                       args: Sequence[str] = None) -> argparse.Namespace:
        if default_config is None:
            default_config = self
        parser = argparse.ArgumentParser()
        for group in _GROUP_TYPES:
            attrs = getattr(default_config, group)
            for f in dataclasses.fields(attrs):
                default_value = getattr(attrs, f.name)
                flag = f'-{group}.{f.name}'
                if isinstance(default_value, (list, tuple)):
                    elem_type = (type(default_value[0])
                                 if len(default_value) else str)
                    parser.add_argument(flag, required=False, nargs='+',
                                        default=default_value, type=elem_type)
                elif isinstance(default_value, bool):
                    parser.add_argument(flag, required=False,
                                        default=default_value,
                                        type=_parse_bool)
                else:
                    parser.add_argument(flag, required=False,
                                        default=default_value,
                                        type=type(default_value))
        return parser.parse_args(args)

    def apply_namespace(self, namespace: argparse.Namespace) -> 'ModelConfiguration':
        """Apply ``-group.attr`` CLI overrides back onto this config."""
        for key, value in vars(namespace).items():
            group, _, attr = key.partition('.')
            if attr and group in _GROUP_TYPES:
                self.update(group, attr, value)
        return self

    def __dir__(self):
        return list(_GROUP_TYPES)


def _parse_bool(value: str) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).lower() in ('1', 'true', 'yes', 'y', 't')


def _coerce_like(current: Any, value: Any) -> Any:
    """Coerce *value* to the container type of the existing field value."""
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(current, list) and isinstance(value, (list, tuple)):
        return list(value)
    return value


def _json_default(obj):
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(f'not JSON serializable: {type(obj)}')
