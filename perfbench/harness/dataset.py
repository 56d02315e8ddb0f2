"""A labelled road dataset drawn from a seed, written as the ETL reads one:
``images/frame_NNNN.jpg`` (cv2's JPEG) and ``labels/<label>/labels.json``
(imglab: COCO-style images, annotations with one polygon each, ``bbox``
as centre x, centre y, width, height)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from . import frames


def write_dataset(data_dir: str, seed: int, count: int,
                  hw: Tuple[int, int], noise: float) -> List[Dict]:
    """Write ``count`` frames and their labels; -> per frame its file name,
    its JPEG bytes and its shapes."""
    image_dir = os.path.join(data_dir, 'images')
    os.makedirs(image_dir, exist_ok=True)
    h, w = hw
    written, by_label = [], {}
    for i in range(count):
        name = f'frame_{i:04d}.jpg'
        img, shapes = frames.road_scene(np.random.default_rng([seed, 3, i]),
                                        hw, noise)
        body = frames.jpeg(img)
        with open(os.path.join(image_dir, name), 'wb') as f:
            f.write(body)
        written.append(dict(file_name=name, jpeg=body, shapes=shapes))
        for label, poly in shapes:
            by_label.setdefault(label, []).append((name, poly))
    images = [{'file_name': d['file_name'], 'id': i + 1, 'width': w,
               'height': h} for i, d in enumerate(written)]
    ids = {d['file_name']: i + 1 for i, d in enumerate(written)}
    for label, items in by_label.items():
        annotations = []
        for aid, (name, poly) in enumerate(items, start=1):
            xs, ys = poly[::2], poly[1::2]
            bw, bh = max(xs) - min(xs), max(ys) - min(ys)
            annotations.append({
                'id': aid, 'image_id': ids[name], 'category_id': 1,
                'segmentation': [poly],
                'bbox': [(max(xs) + min(xs)) / 2, (max(ys) + min(ys)) / 2,
                         bw, bh],
                'area': bw * bh, 'iscrowd': 0, 'ignore': 0})
        label_dir = os.path.join(data_dir, 'labels', label)
        os.makedirs(label_dir, exist_ok=True)
        with open(os.path.join(label_dir, 'labels.json'), 'w') as f:
            json.dump({'images': images, 'annotations': annotations,
                       'categories': [{'id': 1, 'name': label,
                                       'supercategory': 'none'}],
                       'type': 'instances'}, f)
    return written
