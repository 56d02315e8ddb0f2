"""The precision control (the reference in float8 in the program's place)
comes out not correct. At a small size on the CPU it reads several times
what the bfloat16 program reads; the ``gpu`` case runs it at a cell's own
size on the card against the cell's limits (the readings the limits were
set from are in ``limits/<cell>.json``)."""
import pytest

from perfbench.harness import main, spec
from perfbench.tests import small
from perfbench.tools import control

BENCH = spec.load_benchmark()


def test_control_reads_far_above_the_program_small():
    seed = 2 ** 31 + 5
    config = small.small_config('resnet50-bf16')
    traffic = small.small_traffic('batch-summarize', batch=2, judged=3,
                                  warmup_calls=1)
    program = main.run_cell(small.args('resnet50-batch-summarize', seed, 0.5),
                            BENCH, device='cpu', check_card=False,
                            config=config, traffic=traffic,
                            limits=dict(small.LOOSE))['checks']
    ctrl = control.readings('resnet50-batch-summarize', seed, 'cpu', config,
                            traffic, 0.5)
    for k in ('heads_nrmse', 'masks_nrmse'):
        assert ctrl[k] > 3 * program[k]['value'], (k, ctrl, program)


@pytest.mark.gpu
@pytest.mark.parametrize('cell', [c['name'] for c in BENCH['workloads']])
def test_control_fails_the_cells_limits(card, cell):
    from perfbench.harness import env
    env.set_cache_dirs()
    readings = control.readings(cell, 2 ** 31 + 11, card)
    limits = spec.limits_of(cell)
    assert any(v > limits[k] for k, v in readings.items() if k in limits), \
        readings
