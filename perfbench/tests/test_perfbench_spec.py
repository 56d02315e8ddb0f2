"""The harness finds every piece of a cell by name, and BENCHMARK.json
keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from perfbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


@pytest.mark.parametrize('cell', [c['name'] for c in BENCH['workloads']])
def test_cell_pieces_found_by_name(cell):
    c = spec.cell_of(BENCH, cell)
    config = spec.config_of(BENCH, c)
    assert config['model']['compute']['compute_dtype'] in ('float32',
                                                           'bfloat16')
    traffic = spec.traffic_of(c)
    driver = spec.driver(traffic['driver'])
    assert hasattr(driver, 'Session')
    limits = spec.limits_of(cell)
    assert limits and all(v >= 0 for v in limits.values())
    for metric in spec.reported(BENCH, cell, trace=True):
        assert callable(spec.reader(metric['name']))


def test_reduced_keys_are_the_files_own():
    """Each configuration's ``reduced`` in BENCHMARK.json names the cuts
    its file lists under ``reduced``; what the file assumes is not a cut."""
    for c in BENCH['configs']:
        with open(os.path.join(spec.ROOT, c['file'])) as f:
            data = json.load(f)
        assert sorted(c['reduced']) == sorted(data['reduced']), c['name']
        assert not set(c['reduced']) & set(data['assumed']), c['name']


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH['per_layer']:
        assert os.path.isfile(os.path.join(spec.PERFBENCH, 'metrics',
                                           m['name'] + '.py')), m['name']


def test_train_rate_reader():
    """``train.img_per_s``: the window's images over its seconds, None
    where the run counted no window."""
    read = spec.reader('train.img_per_s')
    assert read(dict(counters={'traced_frames': 24, 'window_s': 2.0})) == 12.0
    assert read(dict(counters={'traced_frames': 24})) is None
    assert read(dict(counters={'window_s': 2.0})) is None


def test_contract_shape():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = set()
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/')
        assert NAME.match(c['name']) and c['name'] not in names
        names.add(c['name'])
        assert all(NAME.match(k) for k in c['reduced'])
    used = {w['config'] for w in BENCH['workloads']}
    assert used == names
    pairs = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and w['chips'] in (1, 4)
        assert len(w['why']) <= 200
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25 and UNIT.match(m['unit'])
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert UNIT.match(m['unit']) and NAME.match(m['name'])
        moved = e2e[m['moves']]
        for cell in m['workloads']:
            assert cell in moved.get('workloads', [cell])
    for w in BENCH['workloads']:
        got = spec.reported(BENCH, w['name'], trace=False)
        assert 'setup_s' in {m['name'] for m in got} and len(got) >= 2
        assert spec.reported(BENCH, w['name'], trace=True)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_roofline_names():
    for m in BENCH['per_layer']:
        if 'roofline' in m['name']:
            assert m['name'].split('.')[0].endswith('_roofline')
            assert m['unit'] == '%'
