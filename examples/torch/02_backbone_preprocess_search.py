"""Walkthrough 2 (PyTorch port): the backbone preprocessing search.

The port's counterpart of ``examples/02_backbone_preprocess_search.py``:
given ``<class_name>/<n>.png`` images and an embedding, score every
(rgb x mean_shift x normalize) preprocessing combo by nearest-centroid
accuracy and print the ranking. The frozen winners live in
``masklab_tpu_torch/nn/backbone/preprocess.py`` (``PREPROCESS_COMBOS``).
Without a fixture directory it demonstrates the harness with a
random-feature probe on random images.

    python examples/torch/02_backbone_preprocess_search.py [fixture_dir]
"""
import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np
import torch

from masklab_tpu_torch.nn.backbone.preprocess import preprocess_input

COMBOS = list(itertools.product([True, False], [True, False], [0, 1, 2, 3]))


def search(images, labels, embed_fn):
    """[((rgb, mean_shift, normalize), accuracy)], best first."""
    results = []
    for rgb, mean_shift, normalize in COMBOS:
        batch = torch.from_numpy(np.stack(images).astype(np.float32))
        feats = embed_fn(preprocess_input(batch, rgb, mean_shift,
                                          normalize).numpy())
        feats = feats.reshape(len(feats), -1)
        classes = sorted(set(labels))
        centroids = np.stack([feats[[l == c for l in labels]].mean(0)
                              for c in classes])
        pred = np.argmin(
            ((feats[:, None] - centroids[None]) ** 2).sum(-1), axis=1)
        acc = float(np.mean([classes[p] == l
                             for p, l in zip(pred, labels)]))
        results.append(((rgb, mean_shift, normalize), acc))
    results.sort(key=lambda t: -t[1])
    return results


def main(fixture_dir=None):
    if fixture_dir and os.path.isdir(fixture_dir):
        import cv2
        images, labels = [], []
        for cls in sorted(os.listdir(fixture_dir)):
            sub = os.path.join(fixture_dir, cls)
            if not os.path.isdir(sub):
                continue
            for f in sorted(os.listdir(sub)):
                img = cv2.imread(os.path.join(sub, f))
                if img is None:
                    continue
                images.append(cv2.cvtColor(cv2.resize(img, (64, 64)),
                                           cv2.COLOR_BGR2RGB))
                labels.append(cls)
    else:
        rng = np.random.RandomState(0)
        images = [np.uint8(rng.rand(64, 64, 3) * 255) for _ in range(12)]
        labels = [f'class{i % 3}' for i in range(12)]

    rng = np.random.RandomState(1)
    proj = rng.randn(64 * 64 * 3, 32).astype(np.float32) / 64
    results = search(images, labels, lambda x: x.reshape(len(x), -1) @ proj)
    for (rgb, mean_shift, norm), acc in results[:8]:
        print(f'rgb={rgb!s:5} mean_shift={mean_shift!s:5} '
              f'normalize={norm}  acc={acc:.3f}')
    return results


if __name__ == '__main__':
    main(*sys.argv[1:])
