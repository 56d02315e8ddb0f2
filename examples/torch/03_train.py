"""Walkthrough 3 (PyTorch port): build and train.

The port's counterpart of ``examples/03_train.py``: the 3-phase trainer on
the synthetic dataset with a small road model (``small_road_config``, which
examples 06 and 07 train too), and the LR range test of the reference's
notebook (cell 26): the LR swept exponentially, the loss recorded a step.

    python examples/torch/03_train.py [data_dir] [save_dir] [cuda|cpu]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from masklab_tpu_torch import ModelConfiguration
from masklab_tpu_torch.data import make_synthetic_dataset, process_dataset


def small_road_config(data_dir, save_dir):
    """The road project's defaults (seresnet34, C3..P6 outputs, ratios
    tuned to road objects, min_area 200) at demo widths (32, depth 1)."""
    cfg = ModelConfiguration()
    cfg.backbone.backbone_type = 'seresnet34'
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5', 'P6')
    cfg.detection.pr_ratios = (1 / 2, 1, 2, 5, 8)
    cfg.dataset.min_area = 200.0
    cfg.dataset.data_dir = data_dir
    cfg.train.save_dir = save_dir
    cfg.train.batch_size = 2
    cfg.train.train_head_tune_epoch = 1
    cfg.train.train_waist_tune_epoch = 1
    cfg.train.train_all_epoch = 1
    for group in (cfg.backbone, cfg.detection, cfg.instance, cfg.semantic):
        if hasattr(group, 'num_features'):
            group.num_features = 32
        if hasattr(group, 'num_depth'):
            group.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    cfg.detection.nms_max_output_size = 8
    cfg.loss.nms_max_output_size = 8
    cfg.compute.nms_candidates_per_class = 16
    return cfg


def lr_range_test(trainer, generator, min_lr=1e-6, max_lr=1e-1, steps=20):
    """Exponential LR sweep -> [(lr, loss)] (notebook 3, cell 26)."""
    from masklab_tpu_torch.train import make_train_step, rectified_adam
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), steps))
    trainer._rebuild_state_for_phase(rectified_adam(
        lambda step: float(lrs[min(int(step), steps - 1)])))
    step_fn = make_train_step(trainer.model, with_metrics=False)
    out = []
    for i in range(steps):
        batch = trainer._prepare(generator[i % len(generator)])
        trainer.state, metrics = step_fn(trainer.state, batch)
        out.append((float(lrs[i]), float(metrics['loss'])))
    return out


def main(data_dir=None, save_dir=None, device=None, steps_per_epoch=2):
    """Returns the trainer (``history``, ``ckpt``)."""
    from masklab_tpu_torch.train.trainer import train_masklab_model
    tmp = tempfile.gettempdir()
    data_dir = data_dir or os.path.join(tmp, 'masklab_torch_demo')
    save_dir = save_dir or os.path.join(tmp, 'masklab_torch_logs')
    if not os.path.isdir(os.path.join(data_dir, 'images')):
        make_synthetic_dataset(data_dir, num_images=8)
        process_dataset(data_dir, num_workers=1)
    cfg = small_road_config(data_dir, save_dir)
    trainer = train_masklab_model(cfg, max_gt_boxes=8,
                                  steps_per_epoch=int(steps_per_epoch),
                                  device=device)
    print('history:', trainer.history)
    print('best:', trainer.ckpt.best_checkpoint())
    return trainer


if __name__ == '__main__':
    main(*sys.argv[1:])
