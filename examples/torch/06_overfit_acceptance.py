"""Acceptance gate 1 (PyTorch port): overfit the synthetic set, then check
the whole pipeline end to end.

The port's counterpart of ``examples/06_overfit_acceptance.py``, at its
settings: the small road model of example 03, 12 epochs x 50 steps of the
'all' phase (CyclicLR 1e-4 -> 1e-3, step size 300, one 0.5 scale bucket)
on the 8-image synthetic road set, then the mIoU protocol at the
training-matched resolution (128x160). Fails (AssertionError) unless mask
mIoU > 0.8 and semantic mIoU > 0.6: a gate on the detection, instance and
semantic paths, NMS, the mask paste and the eval harness learning together.

    python examples/torch/06_overfit_acceptance.py [data_dir] [save_dir] [cuda|cpu]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

MASK_MIOU_FLOOR = 0.8
SEMANTIC_MIOU_FLOOR = 0.6


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name[:4], os.path.join(os.path.dirname(__file__), name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_and_evaluate(data_dir, save_dir, device=None, eval_cases=None,
                       epochs=12, steps_per_epoch=50,
                       eval_hw=(128, 160)) -> dict:
    """Train the small road model with the gates' schedule on the processed
    set in ``data_dir``, then evaluate ``eval_cases`` (all images when
    None) at ``eval_hw``. Returns the metrics with ``steps``, ``train_s``,
    ``eval_s`` and ``img_per_s`` (images trained over ``train_s``, the
    smoke check, validation and checkpoints included)."""
    from masklab_tpu_torch.data import MaskLabDataset
    from masklab_tpu_torch.eval import evaluate_dataset
    from masklab_tpu_torch.models import build_masklab
    from masklab_tpu_torch.serving import MaskLabPredictor
    from masklab_tpu_torch.train.checkpoints import load_variables
    from masklab_tpu_torch.train.trainer import train_masklab_model

    cfg = _example('03_train.py').small_road_config(data_dir, save_dir)
    cfg.train.train_head_tune = False
    cfg.train.train_waist_tune = False
    cfg.train.train_all_epoch = epochs
    cfg.train.all_base_lr = 1e-4
    cfg.train.all_max_lr = 1e-3
    cfg.train.all_step_size = 300
    cfg.compute.scale_buckets = (0.5,)
    cfg.train.scale_ratio = (0.5, 0.5)
    start = time.perf_counter()
    trainer = train_masklab_model(cfg, max_gt_boxes=8,
                                  steps_per_epoch=steps_per_epoch,
                                  device=device)
    train_s = time.perf_counter() - start

    start = time.perf_counter()
    eval_cfg = trainer.ckpt.load_config()
    eval_cfg.dataset.data_dir = data_dir
    eval_cfg.postprocess.resolution = tuple(eval_hw)
    model = load_variables(build_masklab(eval_cfg, device=device),
                           trainer.ckpt.restore_variables())
    predictor = MaskLabPredictor(model, eval_cfg, device=device)
    ds = MaskLabDataset(eval_cases, data_dir=data_dir, min_area=200.0)
    if eval_cases is not None and len(ds) != len(eval_cases):
        raise RuntimeError(f'{len(ds)} of {len(eval_cases)} cases loaded')
    metrics = evaluate_dataset(predictor, ds,
                               eval_cfg.dataset.instance_labels,
                               eval_cfg.dataset.semantic_labels)
    steps = epochs * steps_per_epoch
    metrics.update(steps=steps, train_s=train_s,
                   eval_s=time.perf_counter() - start, images=len(ds),
                   img_per_s=steps * cfg.train.batch_size / train_s)
    return metrics


def main(data_dir=None, save_dir=None, device=None, epochs=12,
         steps_per_epoch=50, image_hw=(256, 320), eval_hw=(128, 160),
         check=True) -> dict:
    """Fresh synthetic set (8 images at ``image_hw``) unless ``data_dir``
    holds one, the ETL, the training, the evaluation; ``check`` holds the
    floors. Returns the metrics with ``wall_s``. The defaults are the
    gate's; smaller ``epochs`` / ``steps_per_epoch`` / sizes make a smoke
    run, whose metrics mean nothing."""
    from masklab_tpu_torch.data import make_synthetic_dataset, process_dataset
    start = time.perf_counter()
    tmp = tempfile.gettempdir()
    data_dir = data_dir or os.path.join(tmp, 'masklab_torch_overfit')
    save_dir = save_dir or os.path.join(tmp, 'masklab_torch_acceptance')
    if not os.path.isdir(os.path.join(data_dir, 'images')):
        make_synthetic_dataset(data_dir, num_images=8,
                               image_hw=tuple(image_hw))
        process_dataset(data_dir, num_workers=1)
    metrics = train_and_evaluate(data_dir, save_dir, device,
                                 epochs=int(epochs),
                                 steps_per_epoch=int(steps_per_epoch),
                                 eval_hw=eval_hw)
    metrics['wall_s'] = time.perf_counter() - start
    for k, v in sorted(metrics.items()):
        print(f'{k}: {v:.4f}')
    if check:
        if not (metrics['mask_miou'] > MASK_MIOU_FLOOR
                and metrics['semantic_miou'] > SEMANTIC_MIOU_FLOOR):
            raise AssertionError(
                f'mIoU below the floors (mask > {MASK_MIOU_FLOOR}, '
                f'semantic > {SEMANTIC_MIOU_FLOOR}): {metrics}')
        print('ACCEPTANCE OK')
    return metrics


if __name__ == '__main__':
    main(*sys.argv[1:])
