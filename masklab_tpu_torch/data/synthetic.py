"""Synthetic road-scene data, the port's own copy of
``masklab_tpu/data/synthetic.py``: ``make_synthetic_dataset`` writes a tiny
but fully valid dataset (images + imglab-style polygon labels) for the
ETL -> dataset -> generator -> train pipeline, and ``make_random_batch`` an
in-memory training batch. Both make the reference's draws in its order from
the same seed, so both packages write the same files and batches.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import cv2
import numpy as np

INSTANCE_LABELS = ('car', 'bump', 'manhole', 'steel', 'pothole')
SEMANTIC_LABELS = ('other_road', 'my_road', 'crack')

# Per-class fill colors: the class must be learnable from pixels, not only
# memorizable per image (with one shared colour a held-out detector can
# localize but never classify).
_CLASS_COLORS = {
    'car': (200, 60, 60),
    'bump': (60, 180, 60),
    'manhole': (70, 70, 210),
    'steel': (210, 200, 60),
    'pothole': (180, 60, 200),
}


def _rect_polygon(cx, cy, w, h):
    x1, y1 = cx - w / 2, cy - h / 2
    x2, y2 = cx + w / 2, cy + h / 2
    return [float(v) for v in (x1, y1, x2, y1, x2, y2, x1, y2)]


def make_synthetic_dataset(data_dir: str, num_images: int = 6,
                           image_hw: Tuple[int, int] = (256, 320),
                           seed: int = 0) -> None:
    """Write images/ and labels/<label>/*.json under data_dir."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    image_dir = os.path.join(data_dir, 'images')
    os.makedirs(image_dir, exist_ok=True)

    annos = {label: [] for label in INSTANCE_LABELS + SEMANTIC_LABELS}
    file_names = []
    for i in range(num_images):
        name = f'frame_{i:04d}.jpg'
        file_names.append(name)
        img = (rng.rand(h, w, 3) * 80 + 60).astype(np.uint8)
        # road trapezoid
        road = np.asarray([[w * 0.3, h * 0.4], [w * 0.7, h * 0.4],
                           [w * 0.95, h], [w * 0.05, h]], np.int32)
        cv2.fillPoly(img, [road], (90, 90, 95))
        annos['my_road'].append((name, [
            float(v) for p in road for v in p]))
        annos['other_road'].append((name, _rect_polygon(
            w * 0.15, h * 0.75, w * 0.15, h * 0.45)))
        # a thin dark crack on the road in half the frames: the crack
        # semantic channel end to end (rasterize -> train -> eval's
        # crack-only-when-instances rule)
        if i % 2 == 0:
            ccx = rng.uniform(w * 0.35, w * 0.65)
            ccy = rng.uniform(h * 0.55, h * 0.85)
            length = rng.uniform(0.15, 0.3) * h
            half_w = max(3.0, 0.012 * w)
            slant = rng.uniform(-0.1, 0.1) * h
            crack_poly = [ccx - half_w, ccy - length / 2,
                          ccx + half_w, ccy - length / 2,
                          ccx + half_w + slant, ccy + length / 2,
                          ccx - half_w + slant, ccy + length / 2]
            pts = np.asarray(crack_poly, np.float32).reshape(-1, 2)
            cv2.fillPoly(img, [pts.astype(np.int32)], (45, 42, 48))
            annos['crack'].append((name, [float(v) for v in crack_poly]))
        # a couple of instances per image
        for _ in range(rng.randint(1, 4)):
            label = INSTANCE_LABELS[rng.randint(len(INSTANCE_LABELS))]
            bw = rng.uniform(0.15, 0.35) * w
            bh = rng.uniform(0.15, 0.35) * h
            cx = rng.uniform(bw / 2, w - bw / 2)
            cy = rng.uniform(h * 0.4 + bh / 2, h - bh / 2)
            cv2.rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)),
                          (int(cx + bw / 2), int(cy + bh / 2)),
                          _CLASS_COLORS[label], -1)
            annos[label].append((name, _rect_polygon(cx, cy, bw, bh)))
        cv2.imwrite(os.path.join(image_dir, name), img)

    for label, items in annos.items():
        if not items:
            continue
        label_dir = os.path.join(data_dir, 'labels', label)
        os.makedirs(label_dir, exist_ok=True)
        images = [{'file_name': n, 'id': idx + 1, 'width': w, 'height': h}
                  for idx, n in enumerate(file_names)]
        name_to_id = {n: idx + 1 for idx, n in enumerate(file_names)}
        annotations = []
        for aid, (n, poly) in enumerate(items, start=1):
            xs, ys = poly[::2], poly[1::2]
            bw, bh = max(xs) - min(xs), max(ys) - min(ys)
            annotations.append({
                'id': aid, 'image_id': name_to_id[n],
                'category_id': 1, 'segmentation': [poly],
                'bbox': [(max(xs) + min(xs)) / 2, (max(ys) + min(ys)) / 2,
                         bw, bh],
                'area': bw * bh, 'iscrowd': 0, 'ignore': 0})
        payload = {'images': images, 'annotations': annotations,
                   'categories': [{'id': 1, 'name': label,
                                   'supercategory': 'none'}],
                   'type': 'instances'}
        with open(os.path.join(label_dir, 'labels.json'), 'w') as f:
            json.dump(payload, f)




def make_random_batch(batch_size=2, hw=(128, 128), num_boxes=4,
                      num_det_classes=5, num_seg_classes=3, seed=0):
    """Random images in [0, 255) with 1..num_boxes gt boxes per image
    (cx, cy, w, h, class, conf 1; -1 rows pad), a filled rectangle mask per
    box (-1 planes pad), a random 0/1 semantic map and all-ones exists
    flags. numpy arrays, keyed like the reference generator's feed."""
    rng = np.random.RandomState(seed)
    h, w = hw
    boxes = np.full((batch_size, num_boxes, 6), -1.0, np.float32)
    masks = np.full((batch_size, num_boxes, h, w), -1.0, np.float32)
    for b in range(batch_size):
        n = rng.randint(1, num_boxes + 1)
        for i in range(n):
            bw = rng.uniform(0.2, 0.5) * w
            bh = rng.uniform(0.2, 0.5) * h
            cx = rng.uniform(bw / 2, w - bw / 2)
            cy = rng.uniform(bh / 2, h - bh / 2)
            boxes[b, i] = [cx, cy, bw, bh,
                           rng.randint(num_det_classes), 1.0]
            m = np.zeros((h, w), np.float32)
            x1, y1 = int(cx - bw / 2), int(cy - bh / 2)
            x2, y2 = int(cx + bw / 2), int(cy + bh / 2)
            m[y1:y2, x1:x2] = 1.0
            masks[b, i] = m
    return {
        'images': rng.rand(batch_size, h, w, 3).astype(np.float32) * 255,
        'gt_boxes': boxes,
        'gt_boxes_exist': np.ones((batch_size, num_det_classes), np.float32),
        'gt_masks': masks,
        'gt_seg': (rng.rand(batch_size, h, w, num_seg_classes) > 0.5
                   ).astype(np.float32),
        'gt_seg_exist': np.ones((batch_size, num_seg_classes), np.float32),
    }
