"""Host-side visualization helpers for notebooks / debugging.

The port's copy of ``masklab_tpu/utils/visualize.py`` (numpy and cv2, on
the CPU): a deterministic color map plus cv2-based overlays of semantic
channels and instance boxes/masks on numpy images (the serving path's
drawing on the card lives in ``masklab_tpu_torch/serving/visualize.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def color_map(seed: int = 40) -> np.ndarray:
    """PASCAL-style bit-shuffled [255, 3] uint8 color table."""
    cmap = np.zeros((256, 3), dtype=np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    cmap = cmap[1:]
    rng = np.random.RandomState(seed)
    rng.shuffle(cmap)
    return cmap


def _to_uint8(image: np.ndarray) -> np.ndarray:
    if image.max() <= 1.0:
        return (image * 255).astype(np.uint8)
    return image.copy().astype(np.uint8)


def draw_semantics(image: np.ndarray, segs: np.ndarray,
                   colors: Optional[np.ndarray] = None,
                   alpha: float = 0.3) -> np.ndarray:
    """Alpha-blend per-channel semantic masks [H, W, C] onto an image."""
    import cv2
    image = _to_uint8(image)
    colors = colors if colors is not None else color_map()
    blank = np.zeros_like(image)
    for color, seg in zip(colors, np.transpose(segs, (2, 0, 1))):
        seg = (seg > 0.5).astype(np.uint8)
        layer = (seg[..., None] * color).astype(np.uint8)
        blank = cv2.addWeighted(blank, 1.0, layer, alpha, 1.0)
    return cv2.addWeighted(image, 1.0, blank, 0.9, 1.0)


def draw_instances(image: np.ndarray, boxes: np.ndarray,
                   masks: Optional[np.ndarray] = None,
                   labels: Sequence[str] = (),
                   colors: Optional[np.ndarray] = None,
                   thickness: int = 2) -> np.ndarray:
    """Draw (cx, cy, w, h[, label[, conf]]) boxes + optional full-frame
    masks onto an image."""
    import cv2
    image = _to_uint8(image)
    colors = colors if colors is not None else color_map()
    boxes = np.asarray(boxes)
    valid = boxes[:, 0] != -1
    for idx, box in enumerate(boxes[valid]):
        cx, cy, w, h = box[:4]
        label = int(box[4]) if boxes.shape[1] > 4 else 0
        color = tuple(int(c) for c in colors[label % len(colors)])
        p1 = (int(cx - w / 2), int(cy - h / 2))
        p2 = (int(cx + w / 2), int(cy + h / 2))
        cv2.rectangle(image, p1, p2, color, thickness)
        text = labels[label] if label < len(labels) else str(label)
        if boxes.shape[1] > 5:
            text += f' {float(box[5]):.2f}'
        cv2.putText(image, text, (p1[0], max(p1[1] - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
        if masks is not None and idx < len(masks):
            m = (np.asarray(masks[idx]) > 0.5).astype(np.uint8)
            if m.shape[:2] == image.shape[:2]:
                layer = (m[..., None] * np.asarray(color,
                                                   np.uint8)).astype(np.uint8)
                image = cv2.addWeighted(image, 1.0, layer, 0.35, 0)
    return image
