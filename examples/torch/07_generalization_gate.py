"""Acceptance gate 2 (PyTorch port): train / held-out generalization.

The port's counterpart of ``examples/07_generalization_gate.py``. Example
06 overfits the whole synthetic set and evaluates in-sample; this gate
trains on the ETL's seed-777 90% train split of a 30-image synthetic set
(the same model and schedule as 06) and evaluates the 3 held-out images
with the full mIoU protocol (road_project/train.py:101-212). Fails
(AssertionError) unless mask mIoU and semantic mIoU both exceed 0.5 held
out: the synthetic distribution is narrow, so a model that learns
correctly transfers; below the floors a semantic break, not noise, is the
explanation.

    python examples/torch/07_generalization_gate.py [data_dir] [save_dir] [cuda|cpu]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

MASK_MIOU_FLOOR = 0.5
SEMANTIC_MIOU_FLOOR = 0.5


def main(data_dir=None, save_dir=None, device=None, epochs=12,
         steps_per_epoch=50, check=True) -> dict:
    """Fresh 30-image synthetic set unless ``data_dir`` holds one, the ETL
    and its split, training on the train split, evaluation of the held-out
    split; ``check`` holds the floors. Returns the held-out metrics with
    ``heldout`` and ``trained_on`` (image counts) and ``wall_s``."""
    import importlib.util
    from masklab_tpu_torch.data import make_synthetic_dataset, process_dataset
    from masklab_tpu_torch.data.process import load_split_cases

    start = time.perf_counter()
    tmp = tempfile.gettempdir()
    data_dir = data_dir or os.path.join(tmp, 'masklab_torch_gen30')
    save_dir = save_dir or os.path.join(tmp, 'masklab_torch_gen_gate')
    if not os.path.isdir(os.path.join(data_dir, 'images')):
        make_synthetic_dataset(data_dir, num_images=30)
        process_dataset(data_dir, num_workers=1)
    train_cases, valid_cases = load_split_cases(data_dir)
    if not (train_cases and valid_cases) or set(train_cases) & set(
            valid_cases):
        raise RuntimeError('the ETL gave no disjoint train / held-out split')

    spec = importlib.util.spec_from_file_location(
        'ex06', os.path.join(os.path.dirname(__file__),
                             '06_overfit_acceptance.py'))
    ex06 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex06)
    # the trainer picks the split CSVs up itself (construct_masklab_datasets)
    metrics = ex06.train_and_evaluate(data_dir, save_dir, device,
                                      eval_cases=valid_cases,
                                      epochs=int(epochs),
                                      steps_per_epoch=int(steps_per_epoch))
    metrics.update(heldout=len(valid_cases), trained_on=len(train_cases),
                   wall_s=time.perf_counter() - start)
    for k, v in sorted(metrics.items()):
        print(f'heldout {k}: {v:.4f}')
    if check:
        if not (metrics['mask_miou'] > MASK_MIOU_FLOOR
                and metrics['semantic_miou'] > SEMANTIC_MIOU_FLOOR):
            raise AssertionError(
                f'held-out mIoU below the floors (mask > {MASK_MIOU_FLOOR}, '
                f'semantic > {SEMANTIC_MIOU_FLOOR}): {metrics}')
        print('GENERALIZATION GATE OK (held out '
              f'{len(valid_cases)} of {len(valid_cases) + len(train_cases)} '
              'images)')
    return metrics


if __name__ == '__main__':
    main(*sys.argv[1:])
