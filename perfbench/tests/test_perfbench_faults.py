"""A whole run on the CPU at a small size, the card check skipped: sound,
it comes out correct; with the timed path broken underneath
(``tools/faults.py``) it comes out not correct, once for each fault a cell
can have: in the batch cell, a proposal box, a mask or an analytics row
altered where it is produced, and half of a batch answered with the other
half's outputs; in training, a step that leaves
the state unchanged, a step whose loss leaves half of the batch out, and
one whose total leaves the mask head's loss out."""
import numpy as np
import pytest

from perfbench.harness import main, spec
from perfbench.tests import small
from perfbench.tools import faults

BENCH = spec.load_benchmark()
# limits for this small size (its sound readings sit well under them)
LIMITS = dict(judged_missing=0, heads_nrmse=0.25, masks_nrmse=0.3,
              rows_gap=1e-3, input_gap=0.0, nms_rows_off=0)


def _batch_run(seed=2 ** 31 + 99):
    traffic = small.small_traffic('batch-summarize', batch=2, judged=3,
                                  warmup_calls=1)
    return main.run_cell(small.args('resnet50-batch-summarize', seed, 0.5),
                         BENCH, device='cpu', check_card=False,
                         config=small.small_config('resnet50-bf16'),
                         traffic=traffic, limits=LIMITS)


def test_sound_runs_are_correct():
    out = _batch_run()
    assert out['correct'], out['checks']
    assert set(out['metrics']) == {'setup_s', 'frames_per_s'}


@pytest.mark.parametrize('fault', ['proposals_moved', 'masks_altered',
                                   'rows_altered', 'half_batch_answered'])
def test_broken_batch_path_is_not_correct(fault):
    with faults.FAULTS[fault]():
        out = _batch_run()
    assert not out['correct'], out['checks']


def _train_run(seed=2 ** 31 + 97):
    return main.run_cell(small.args('road-train-all', seed, 2.0), BENCH,
                         device='cpu', check_card=False,
                         config=small.small_train_config(),
                         traffic=small.small_train_traffic(),
                         limits=TRAIN_LIMITS)


# limits for this small size (its sound readings sit well under them)
TRAIN_LIMITS = dict(grad_gap=0.05, change_gap=0.05, grad_group_gap=0.1,
                    change_group_gap=0.1, stats_gap=0.1, box_gap=0.1,
                    start_gap=0.0, data_rows_off=0, data_boxes_gap=1.0)


def test_sound_train_run_is_correct():
    out = _train_run()
    assert out['correct'], out['checks']
    assert set(out['metrics']) == {'setup_s', 'train_peak_gib'}


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch_loss',
                                   'mask_loss_dropped'])
def test_broken_train_step_is_not_correct(fault):
    with faults.FAULTS[fault]():
        out = _train_run()
    assert not out['correct'], out['checks']
    if fault == 'mask_loss_dropped':
        # one head's fault: its group's median leaf fails, the median leaf
        # of the whole model does not
        checks = out['checks']
        assert (checks['change_group_gap']['value']
                > TRAIN_LIMITS['change_group_gap']), checks
        assert checks['change_gap']['value'] < TRAIN_LIMITS['change_gap']
