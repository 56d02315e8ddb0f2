"""Walkthrough 4 (PyTorch port): evaluation.

The port's counterpart of ``examples/04_evaluate.py``: the mask-mIoU /
semantic-mIoU harness (the reference's road_project/train.py:101-212) over
the synthetic set with the best checkpoint of ``save_dir``, or seeded random
weights.

    python examples/torch/04_evaluate.py [data_dir] [save_dir] [cuda|cpu]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))


def demo_config(resolution):
    """A small mobilenet model (widths 32, depth 1)."""
    from masklab_tpu_torch import ModelConfiguration
    cfg = ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.num_features = 32
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 32
        g.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    cfg.detection.nms_max_output_size = 16
    cfg.compute.nms_candidates_per_class = 32
    cfg.postprocess.resolution = resolution
    return cfg


def main(data_dir=None, save_dir=None, device=None, max_images=4):
    """Returns the metrics ({'mask_miou', 'semantic_miou', ...})."""
    from masklab_tpu_torch.data import (MaskLabDataset,
                                        make_synthetic_dataset,
                                        process_dataset)
    from masklab_tpu_torch.eval import evaluate_dataset
    from masklab_tpu_torch.models import build_masklab
    from masklab_tpu_torch.serving import MaskLabPredictor
    from masklab_tpu_torch.train.checkpoints import (CheckpointManager,
                                                     load_variables)

    data_dir = data_dir or os.path.join(tempfile.gettempdir(),
                                        'masklab_torch_demo')
    if not os.path.isdir(os.path.join(data_dir, 'images')):
        make_synthetic_dataset(data_dir, num_images=8)
        process_dataset(data_dir, num_workers=1)

    cfg = demo_config((256, 320))
    cfg.dataset.data_dir = data_dir
    cfg.dataset.min_area = 100.0
    if save_dir and os.path.isdir(save_dir):
        ckpt = CheckpointManager(save_dir)
        saved_cfg = ckpt.load_config()
        if saved_cfg is not None:
            saved_cfg.dataset = cfg.dataset
            saved_cfg.postprocess.resolution = cfg.postprocess.resolution
            cfg = saved_cfg
        model = load_variables(build_masklab(cfg, device=device),
                               ckpt.restore_variables())
    else:
        model = build_masklab(cfg, device=device)
    predictor = MaskLabPredictor(model, cfg, device=device)

    validset = MaskLabDataset(data_dir=data_dir, min_area=100.0)
    metrics = evaluate_dataset(predictor, validset,
                               cfg.dataset.instance_labels,
                               cfg.dataset.semantic_labels,
                               max_images=int(max_images))
    for k, v in sorted(metrics.items()):
        print(f'{k}: {v:.4f}')
    return metrics


if __name__ == '__main__':
    main(*sys.argv[1:])
