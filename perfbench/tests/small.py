"""Small stand-ins for the cells' configurations and traffic, for runs of
the harness on the CPU: the same model families at narrow widths and one
block of depth, frames of 216x384 served at 108x192."""
from __future__ import annotations

import copy
import json
import os
from types import SimpleNamespace

from perfbench.harness import spec

FRAME_HW = (216, 384)


def small_config(name: str) -> dict:
    with open(os.path.join(spec.PERFBENCH, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    m = cfg['model']
    m['postprocess']['resolution'] = [108, 192]
    m['backbone']['num_features'] = 16
    for group in ('detection', 'instance', 'semantic'):
        m[group]['num_features'] = 16
        m[group]['num_depth'] = 1
    m['semantic']['num_aspp_features'] = 16
    m['semantic']['num_skip_features'] = 8
    m['detection']['nms_max_output_size'] = 8
    m['postprocess']['nms_max_output_size'] = 8
    m['compute']['nms_candidates_per_class'] = 16
    return cfg


def small_traffic(name: str, **changes) -> dict:
    t = copy.deepcopy(spec.traffic_of({'traffic': name}))
    t['frame_hw'] = list(FRAME_HW)
    t.update(changes)
    return t


def args(workload: str, seed: int, seconds: float = 1.0, trace: int = 0):
    return SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                           trace=trace)


LOOSE = {'judged_missing': 0, 'heads_nrmse': 1.0, 'nms_rows_off': 0,
         'masks_nrmse': 1.0, 'rows_gap': 1.0, 'input_gap': 0.0}


def small_train_traffic(**changes) -> dict:
    t = copy.deepcopy(spec.traffic_of({'traffic': 'train-all'}))
    t.update(frames=6, frame_hw=[320, 576])
    t.update(changes)
    return t


def small_train_config() -> dict:
    cfg = small_config('road-seresnet34-bf16')
    cfg['model']['train']['batch_size'] = 2
    cfg['model']['loss']['nms_max_output_size'] = 8
    cfg['model']['compute']['nms_candidates_per_class_train'] = 16
    return cfg
