"""imglab (COCO-style) label format <-> annotation rows.

The port's own copy of ``masklab_tpu/data/imglab.py``, without pandas: a
table is a list of row dicts with the columns of the reference's DataFrame.
The imglab tool emits a COCO-ish json where ``bbox`` is (center_x, center_y,
w, h), NOT the COCO (x, y, w, h) corner convention.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .tables import sort_order


def imglabformat_to_dataframe(imglab: Dict) -> List[Dict]:
    """json dict -> rows {file_name, segmentation, name, bbox}, one per
    annotation, in the json's order."""
    files = {im['id']: im['file_name'] for im in imglab['images']}
    names = {c['id']: c['name'] for c in imglab['categories']}
    return [{'file_name': files.get(a['image_id']),
             'segmentation': a['segmentation'],
             'name': names.get(a['category_id']), 'bbox': a['bbox']}
            for a in imglab['annotations']]


def image_file_names(imglab: Dict) -> List[str]:
    """The json's image list (the reference's file_name categories)."""
    return list(dict.fromkeys(im['file_name'] for im in imglab['images']))


def dataframe_to_imglabformat(rows: List[Dict],
                              image_wh=(1920, 1080)) -> Dict:
    """Inverse adapter: rows -> imglab json dict. Image and category ids
    number the sorted unique file names and names from 1 (pandas'
    categories of a plain column); each image's annotations are ordered by
    area, largest first, as the reference's ``sort_values`` orders them."""
    files = sorted({r['file_name'] for r in rows})
    names = sorted({r['name'] for r in rows})
    file_id = {f: i + 1 for i, f in enumerate(files)}
    name_id = {n: i + 1 for i, n in enumerate(names)}
    images = [{'id': i + 1, 'file_name': f, 'width': image_wh[0],
               'height': image_wh[1]} for i, f in enumerate(files)]
    categories = [{'id': i + 1, 'name': n, 'supercategory': 'none'}
                  for i, n in enumerate(names)]

    annos = []
    for r in rows:
        poly = r['segmentation'][0]
        min_x, max_x = min(poly[::2]), max(poly[::2])
        min_y, max_y = min(poly[1::2]), max(poly[1::2])
        w, h = max_x - min_x, max_y - min_y
        # the reference's column order: the row's own columns but file_name
        # and name, then image_id, category_id, ignore, iscrowd, area
        anno = {k: v for k, v in r.items() if k not in ('file_name', 'name')}
        anno.update(image_id=file_id[r['file_name']],
                    category_id=name_id[r['name']], ignore=0, iscrowd=0)
        anno['bbox'] = [(min_x + max_x) / 2, (min_y + max_y) / 2, w, h]
        anno['area'] = float(w * h)
        annos.append(anno)
    out = []
    for image_id in sorted({a['image_id'] for a in annos}):
        group = [a for a in annos if a['image_id'] == image_id]
        order = sort_order(np.asarray([a['area'] for a in group],
                                      np.float64), ascending=False)
        out += [group[i] for i in order]
    annotations = [{'id': i + 1, **a} for i, a in enumerate(out)]
    return {'images': images, 'annotations': annotations,
            'categories': categories, 'type': 'instances'}
