"""Offline ETL: imglab polygons -> tensors-on-disk.

The port's own copy of ``masklab_tpu/data/process.py``, without pandas (the
tables go through ``tables``), writing the same files byte for byte:
  * scan ``labels/<label_name>/*.json`` into a per-image label-existence
    table + annotation table;
  * rasterize semantic polygons per label minus the except-labels (car)
    regions, with cv2.fillPoly (the native filler where cv2 is missing);
  * rasterize each instance polygon cropped to its bbox;
  * write label_exists.tsv, the seed-777 90/10 train/valid CSVs, and
    boxes.tsv with a global mask_index; rasterization fans out over a
    multiprocessing pool (spawned workers: the caller may hold CUDA and
    thread pools, which a fork would copy mid-flight).

The annotation order, which decides boxes.tsv's rows and each instance
PNG's ``mask_index``, is the reference's: its ``sort_values('file_name')``
is numpy's unstable quicksort on the categorical's codes when every label's
jsons list the same images, and a stable sort of the names otherwise (the
column is then pandas' arrow-backed ``str``); its ``groupby`` then keeps
that order within each file.
"""
from __future__ import annotations

import json
import os
import random
from functools import partial
from multiprocessing import cpu_count, get_context
from typing import Dict, List, Sequence, Tuple

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present where the port runs
    cv2 = None
import numpy as np

from .imglab import image_file_names, imglabformat_to_dataframe
from .tables import category_codes, sort_order, write_table

IMAGE_FORMATS = ('.jpg', '.jpeg', '.png')
BOX_COLUMNS = ('file_name', 'cx', 'cy', 'w', 'h', 'label', 'mask_index')


def load_split_cases(data_dir: str):
    """(train_cases, valid_cases) from the ETL's seed-777 split CSVs, or
    (None, None) when the dataset has not been processed or has no
    held-out rows, so that callers fall back to all images."""
    processed = os.path.join(data_dir, 'processed')
    out = []
    for name in ('train.csv', 'valid.csv'):
        path = os.path.join(processed, name)
        if not os.path.isfile(path):
            return None, None
        with open(path) as f:
            cases = [line.strip() for line in f if line.strip()]
        out.append(cases)
    if not out[0] or not out[1]:
        return None, None
    return out[0], out[1]


def get_image_cases(image_dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(image_dir):
        for f in files:
            if os.path.splitext(f)[1].lower() in IMAGE_FORMATS:
                out.append(f)
    return sorted(out)


def load_label_dataframes_from_imglab_files(label_dir: str
                                            ) -> Tuple[List[Dict],
                                                       List[Dict]]:
    """labels/<label_name>/*.json -> (label_exists rows {file_name, <label>:
    bool ...}, annotation rows {file_name, cx, cy, w, h, label,
    annotation [P, 2] float64}) in the reference's row order."""
    per_label: Dict[str, Tuple[List[Dict], List[str]]] = {}
    for label_name in sorted(os.listdir(label_dir)):
        sub = os.path.join(label_dir, label_name)
        if not os.path.isdir(sub):
            continue
        jsons = [n for n in sorted(os.listdir(sub))
                 if os.path.splitext(n)[1].lower() == '.json']
        if not jsons:
            continue
        rows, file_names = [], set()
        for file_name in jsons:
            with open(os.path.join(sub, file_name)) as f:
                payload = json.load(f)
            rows += imglabformat_to_dataframe(payload)
            file_names |= set(image_file_names(payload))
        per_label[label_name] = (rows, sorted(file_names))

    annotated = sorted({r['file_name'] for rows, _ in per_label.values()
                        for r in rows})
    listed = {k: set(names) for k, (_, names) in per_label.items()}
    label_exists = [{'file_name': f, **{k: f in listed[k] for k in per_label}}
                    for f in annotated]

    annotations = [
        {'file_name': r['file_name'], 'cx': r['bbox'][0],
         'cy': r['bbox'][1], 'w': r['bbox'][2], 'h': r['bbox'][3],
         'label': label,
         'annotation': np.asarray(r['segmentation'],
                                  dtype=np.float64).reshape(-1, 2)}
        for label, (rows, _) in per_label.items() for r in rows]
    annotations = [a for a in annotations if (a['w'] * a['h']) > 0]
    categories = [names for _, names in per_label.values()]
    names = [a['file_name'] for a in annotations]
    if all(c == categories[0] for c in categories):
        order = sort_order(category_codes(names, categories[0]))
    else:
        order = sorted(range(len(names)), key=names.__getitem__)
    return label_exists, [annotations[i] for i in order]


def _fill_polygon(mask: np.ndarray, points: np.ndarray) -> None:
    h, w = mask.shape[:2]
    pts = points.copy()
    pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
    pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
    # cv2's SIMD fillPoly is the reference's preferred filler; the native
    # scanline filler covers cv2-less hosts
    if cv2 is not None:
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return
    from ..native import fill_polygon_native
    if not fill_polygon_native(mask, pts, 1):
        raise RuntimeError('no polygon rasterizer available '
                           '(need cv2 or a C++ toolchain)')


def _bbox(row: Dict) -> np.ndarray:
    """(x1, y1, x2, y2) of a box row, truncated to int64, clamped at 0."""
    bbox = np.asarray((row['cx'] - row['w'] / 2, row['cy'] - row['h'] / 2,
                       row['cx'] + row['w'] / 2, row['cy'] + row['h'] / 2),
                      np.int64)
    return np.maximum(bbox, 0)


def process_semantic(inputs, data_dir: str, semantic_labels: Sequence[str],
                     except_semantic_labels: Sequence[str]) -> None:
    """Rasterize + save 1-bit semantic PNGs for one image."""
    image_dir = os.path.join(data_dir, 'images')
    processed_dir = os.path.join(data_dir, 'processed')
    file_name, rows = inputs
    save_dir = os.path.join(processed_dir, f'semantic/{file_name}')
    os.makedirs(save_dir, exist_ok=True)

    shape = None
    except_mask = None
    for label in semantic_labels:
        save_path = os.path.join(save_dir, f'{label}.png')
        if os.path.exists(save_path) or not any(r['label'] == label
                                                for r in rows):
            continue
        if shape is None:
            shape = cv2.imread(os.path.join(image_dir, file_name)).shape[:2]
            except_mask = np.zeros(shape, np.uint8)
            for except_label in except_semantic_labels:
                for r in rows:
                    if r['label'] == except_label:
                        _fill_polygon(except_mask, r['annotation'])
        mask = np.zeros(shape, np.uint8)
        for r in rows:
            if r['label'] == label:
                _fill_polygon(mask, r['annotation'])
        label_mask = ((mask.astype(np.int32)
                       - except_mask.astype(np.int32)) > 0).astype(np.uint8)
        cv2.imwrite(save_path, label_mask, [cv2.IMWRITE_PNG_COMPRESSION, 9])


def process_instance(inputs, data_dir: str,
                     instance_labels: Sequence[str]) -> None:
    """Rasterize + save per-instance bbox-cropped PNGs for one image."""
    image_dir = os.path.join(data_dir, 'images')
    processed_dir = os.path.join(data_dir, 'processed')
    file_name, rows = inputs
    save_dir = os.path.join(processed_dir, f'instance/{file_name}')
    os.makedirs(save_dir, exist_ok=True)

    shape = None
    for row in rows:
        if row['label'] not in instance_labels:
            continue
        save_path = os.path.join(save_dir, f'{row["mask_index"]}.png')
        if os.path.exists(save_path):
            continue
        if shape is None:
            shape = cv2.imread(os.path.join(image_dir, file_name)).shape[:2]
        blank = np.zeros(shape, np.uint8)
        _fill_polygon(blank, row['annotation'])
        x1, y1, x2, y2 = _bbox(row)
        cv2.imwrite(save_path, blank[y1:y2 + 1, x1:x2 + 1],
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])


def process_dataset(data_dir: str,
                    except_semantic_labels: Sequence[str] = ('car',),
                    num_workers: int = None) -> None:
    """Full ETL entry (the reference's process.py:171-247)."""
    image_dir = os.path.join(data_dir, 'images/')
    label_dir = os.path.join(data_dir, 'labels/')
    processed_dir = os.path.join(data_dir, 'processed/')
    os.makedirs(processed_dir, exist_ok=True)

    label_exists, annotations = \
        load_label_dataframes_from_imglab_files(label_dir)
    labels = [k for k in (label_exists[0] if label_exists else {})
              if k != 'file_name']

    existing = set(os.listdir(image_dir))
    write_table(os.path.join(processed_dir, 'label_exists.tsv'),
                ['file_name', *labels],
                [r for r in label_exists if r['file_name'] in existing])

    fnames = get_image_cases(image_dir)
    # the reference's global random.seed(777); random.shuffle: the same
    # draws from a generator of its own
    random.Random(777).shuffle(fnames)
    valid_n = int(len(fnames) * 0.1)
    for name, part in (('train.csv', fnames[valid_n:]),
                       ('valid.csv', fnames[:valid_n])):
        write_table(os.path.join(processed_dir, name), ['file_name'],
                    [{'file_name': f} for f in part], sep=',',
                    header=False)

    annotations = [a for a in annotations if a['file_name'] in existing]
    groups: Dict[str, List[Dict]] = {}
    for a in annotations:
        groups.setdefault(a['file_name'], []).append(a)
    annotations = [a for f in sorted(groups) for a in groups[f]]
    for i, a in enumerate(annotations):
        a['mask_index'] = i
    write_table(os.path.join(processed_dir, 'boxes.tsv'), BOX_COLUMNS,
                annotations)

    groups = [(f, groups[f]) for f in sorted(groups)]
    workers = num_workers if num_workers is not None else cpu_count()
    sem_work = partial(process_semantic, data_dir=data_dir,
                       semantic_labels=labels,
                       except_semantic_labels=except_semantic_labels)
    ins_work = partial(process_instance, data_dir=data_dir,
                       instance_labels=labels)
    if workers <= 1:
        for g in groups:
            sem_work(g)
        for g in groups:
            ins_work(g)
    else:
        ctx = get_context('spawn')
        with ctx.Pool(workers) as pool:
            list(pool.imap_unordered(sem_work, groups))
        with ctx.Pool(workers) as pool:
            list(pool.imap_unordered(ins_work, groups))
