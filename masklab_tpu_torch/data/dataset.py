"""MaskLab dataset: disk -> padded numpy batch dicts.

The port's own copy of ``masklab_tpu/data/dataset.py``, reading the ETL's
tables without pandas (``tables``; floats parsed as pandas parses them, so
the arrays are the reference's bit for bit). It reads ``label_exists.tsv``
+ ``boxes.tsv``, filters boxes by min_area (strictly greater) and the
instance-label set, and assembles per-sample dicts with the reference's
key/value contract:

  images [H,W,3] uint8 RGB; semantic [H,W,S] uint8; semantic_exist [S];
  detection [G,6] (cx,cy,w,h,label,conf) padded -1; instance [G,H,W] int8
  (full-frame re-rasterized from bbox-cropped PNGs) padded -1;
  instance_exist [I].
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import cv2
import numpy as np

from ..utils.profiling import count
from .tables import parse_float, read_table


def read_image(filepath: str) -> np.ndarray:
    """An RGB image; each call counts one ``data.decoded_images``."""
    count('data.decoded_images')
    image = cv2.imread(filepath)
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def read_mask(filepath: str) -> np.ndarray:
    return cv2.imread(filepath, cv2.IMREAD_UNCHANGED)


def _field(value: str):
    """A label_exists field as pandas types it: True / False, else the
    string."""
    return {'True': True, 'False': False}.get(value, value)


class MaskLabDataset:
    def __init__(self, cases: Optional[Sequence[str]] = None,
                 instance_labels=('car', 'bump', 'manhole', 'steel',
                                  'pothole'),
                 semantic_labels=('other_road', 'my_road', 'crack'),
                 data_dir: str = './datasets/', min_area: float = 1000.0,
                 **kwargs):
        self.data_dir = data_dir
        self.image_dir = os.path.join(data_dir, 'images/')
        self.process_dir = os.path.join(data_dir, 'processed/')
        self.semantic_dir = os.path.join(self.process_dir, 'semantic/')
        self.instance_dir = os.path.join(self.process_dir, 'instance/')
        if cases is None:
            from .process import get_image_cases
            self.cases = np.asarray(get_image_cases(self.image_dir))
        else:
            self.cases = np.asarray(list(cases))
        self.instance_labels = tuple(instance_labels)
        self.semantic_labels = tuple(semantic_labels)
        self.min_area = min_area

        # file_name -> its first label_exists row (the reference reads the
        # first match)
        self.label_exists: Dict[str, Dict] = {}
        for row in read_table(os.path.join(self.process_dir,
                                           'label_exists.tsv')):
            self.label_exists.setdefault(
                row['file_name'], {k: _field(v) for k, v in row.items()})
        # file_name -> [(cx, cy, w, h, label index, mask_index)] of the kept
        # boxes, in boxes.tsv's order
        self.boxes: Dict[str, list] = {}
        for row in read_table(os.path.join(self.process_dir, 'boxes.tsv')):
            if row['label'] not in self.instance_labels:
                continue
            cx, cy, w, h = (parse_float(row[k]) for k in ('cx', 'cy', 'w',
                                                          'h'))
            if not (w * h) > self.min_area:
                continue
            self.boxes.setdefault(row['file_name'], []).append(
                (cx, cy, w, h, self.instance_labels.index(row['label']),
                 int(row['mask_index'])))

        self.config = {
            'cases': list(self.cases),
            'instance_labels': self.instance_labels,
            'semantic_labels': self.semantic_labels,
            'data_dir': data_dir, 'min_area': min_area,
        }
        self.config.update(kwargs)

    def __len__(self) -> int:
        return len(self.cases)

    def shuffle(self, rng: Optional[np.random.RandomState] = None) -> None:
        (rng or np.random).shuffle(self.cases)

    def get_config(self) -> Dict:
        return self.config

    # ---- per-sample loaders ----

    def get_semantic_mask(self, case_name: str, image_size) -> np.ndarray:
        h, w = image_size[:2]
        out = np.zeros((h, w, len(self.semantic_labels)), np.uint8)
        for idx, label in enumerate(self.semantic_labels):
            path = os.path.join(self.semantic_dir, f'{case_name}/{label}.png')
            if os.path.exists(path):
                out[..., idx] = read_mask(path)
        return out

    def _exist_row(self, case_name: str, labels) -> np.ndarray:
        row = self.label_exists.get(case_name, {})
        return np.asarray([float(row[l]) if l in row else 0.0
                           for l in labels], np.float64)

    def get_semantic_exist(self, case_name: str) -> np.ndarray:
        return self._exist_row(case_name, self.semantic_labels)

    def get_instance_exist(self, case_name: str) -> np.ndarray:
        return self._exist_row(case_name, self.instance_labels)

    def get_detection(self, case_name: str) -> np.ndarray:
        rows = self.boxes.get(case_name, [])
        return np.asarray([r[:5] + (1.0,) for r in rows],
                          np.float64).reshape(-1, 6)

    def get_instance(self, case_name: str, image_size) -> np.ndarray:
        """Re-rasterize bbox-cropped instance PNGs into full frames."""
        h, w = image_size[:2]
        rows = self.boxes.get(case_name, [])
        out = np.zeros((len(rows), h, w), np.uint8)
        inst_dir = os.path.join(self.instance_dir, case_name)
        for idx, (cx, cy, bw, bh, _, mask_index) in enumerate(rows):
            bbox = np.asarray((cx - bw / 2, cy - bh / 2, cx + bw / 2,
                               cy + bh / 2), np.int64)
            x1, y1, x2, y2 = np.maximum(bbox, 0)
            path = os.path.join(inst_dir, f'{mask_index}.png')
            region = out[idx, y1:y2 + 1, x1:x2 + 1]
            if os.path.exists(path) and region.size:
                mask = read_mask(path)
                out[idx, y1:y2 + 1, x1:x2 + 1] = cv2.resize(
                    mask, region.shape[::-1],
                    interpolation=cv2.INTER_NEAREST)
        return out

    # ---- indexing ----

    def _single(self, case_name: str) -> Dict:
        image = read_image(os.path.join(self.image_dir, case_name))
        return {
            'images': image,
            'semantic': self.get_semantic_mask(case_name, image.shape[:2]),
            'semantic_exist': self.get_semantic_exist(case_name),
            'detection': self.get_detection(case_name),
            'instance': self.get_instance(case_name, image.shape[:2]),
            'instance_exist': self.get_instance_exist(case_name),
        }

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            return self._single(self.cases[index])
        if isinstance(index, str):
            return self._single(index)
        cases = self.cases[index]
        first = read_image(os.path.join(self.image_dir, cases[0]))
        height, width = first.shape[:2]
        counts = [len(self.boxes[c]) for c in set(cases) if self.boxes.get(c)]
        max_instances = max(counts) if counts else 1

        n = len(cases)
        images = np.zeros((n, height, width, 3), np.uint8)
        semantic = np.zeros((n, height, width, len(self.semantic_labels)),
                            np.uint8)
        semantic_exist = np.zeros((n, len(self.semantic_labels)))
        instance_exist = np.zeros((n, len(self.instance_labels)))
        detection = np.full((n, max_instances, 6), -1.0)
        instance = np.full((n, max_instances, height, width), -1, np.int8)

        for i, case_name in enumerate(cases):
            images[i] = cv2.resize(
                read_image(os.path.join(self.image_dir, case_name)),
                (width, height))
            semantic[i] = cv2.resize(
                self.get_semantic_mask(case_name, (height, width)),
                (width, height)).reshape(height, width, -1)
            semantic_exist[i] = self.get_semantic_exist(case_name)
            instance_exist[i] = self.get_instance_exist(case_name)
            det = self.get_detection(case_name)
            detection[i, :len(det)] = det
            inst = self.get_instance(case_name, (height, width))
            instance[i, :len(inst)] = inst
        return {'images': images, 'semantic': semantic,
                'semantic_exist': semantic_exist, 'detection': detection,
                'instance': instance, 'instance_exist': instance_exist}
