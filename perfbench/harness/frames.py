"""Road-like dashcam frames drawn from a seed: the benchmark's copy of the
synthetic road-scene drawer (sky and verge, the road trapezoid with lane
marks, a crack, a few boxy road objects in their class colours), with mild
sensor noise, and their JPEG bytes at cv2's default quality; with
``road_scene`` also the labels of what was drawn, as polygons."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

INSTANCE_LABELS = ('car', 'bump', 'manhole', 'steel', 'pothole')
CLASS_COLORS = ((200, 60, 60), (60, 180, 60), (70, 70, 210), (210, 200, 60),
                (180, 60, 200))


def road_frame(rng: np.random.Generator, hw: Tuple[int, int],
               noise: float) -> np.ndarray:
    """One RGB uint8 [H, W, 3] frame."""
    return road_scene(rng, hw, noise)[0]


def road_scene(rng: np.random.Generator, hw: Tuple[int, int], noise: float
               ) -> Tuple[np.ndarray, List[Tuple[str, List[float]]]]:
    """One RGB uint8 [H, W, 3] frame and its labels: (label, polygon as
    flat x, y pairs) for the road (``my_road``), the verges
    (``other_road``), the crack and each road object, in drawing order."""
    import cv2
    h, w = hw
    shapes = []
    img = np.empty((h, w, 3), np.uint8)
    horizon = int(h * rng.uniform(0.35, 0.45))
    sky = np.linspace(rng.uniform(150, 210), rng.uniform(110, 150), horizon)
    img[:horizon] = np.clip(sky[:, None, None] * (1.0, 1.05, 1.15), 0,
                            255).astype(np.uint8)
    verge = rng.uniform(70, 110, 3)
    img[horizon:] = verge.astype(np.uint8)
    cx = w * rng.uniform(0.42, 0.58)
    road = np.asarray([[cx - w * 0.08, horizon], [cx + w * 0.08, horizon],
                       [w * 0.98, h], [w * 0.02, h]], np.int32)
    tone = int(rng.uniform(80, 105))
    cv2.fillPoly(img, [road], (tone, tone, tone + 4))
    shapes.append(('my_road', road.reshape(-1).astype(float).tolist()))
    shapes.append(('other_road', [0.0, float(horizon), float(road[0, 0]),
                                  float(horizon), float(road[3, 0]), float(h),
                                  0.0, float(h)]))
    for side in (-1, 1):
        for t0 in np.arange(0.0, 1.0, 0.12):
            t1 = t0 + 0.06
            pts = [(cx + side * w * (0.03 + 0.25 * t), horizon +
                    (h - horizon) * t) for t in (t0, t1)]
            cv2.line(img, tuple(map(int, pts[0])), tuple(map(int, pts[1])),
                     (230, 230, 220), max(2, int(w * 0.004 * (1 + t0 * 3))))
    if rng.uniform() < 0.5:
        y = int(rng.uniform(horizon + 0.3 * (h - horizon), h * 0.9))
        x = int(cx + rng.uniform(-0.1, 0.1) * w)
        dx = int(rng.uniform(-60, 60))
        cv2.line(img, (x, y), (x + dx, y + 120), (45, 42, 48), 5)
        shapes.append(('crack', [x - 3.0, float(y), x + 3.0, float(y),
                                 x + dx + 3.0, y + 120.0, x + dx - 3.0,
                                 y + 120.0]))
    for _ in range(int(rng.integers(2, 6))):
        k = int(rng.integers(len(CLASS_COLORS)))
        color = CLASS_COLORS[k]
        t = rng.uniform(0.1, 0.9)
        y = horizon + (h - horizon) * t
        bh = (h - horizon) * (0.05 + 0.25 * t)
        bw = bh * rng.uniform(0.8, 2.0)
        x = cx + rng.uniform(-0.45, 0.45) * w * t
        x1, y1, x2, y2 = int(x - bw / 2), int(y - bh), int(x + bw / 2), int(y)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, w - 1), min(y2, h - 1)
        if x2 > x1 and y2 > y1:
            shapes.append((INSTANCE_LABELS[k], [float(v) for v in (
                x1, y1, x2, y1, x2, y2, x1, y2)]))
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    if noise > 0:
        grain = rng.normal(0.0, noise, (h // 3, w // 3, 3)).astype(np.float32)
        grain = cv2.resize(grain, (w, h), interpolation=cv2.INTER_LINEAR)
        img = cv2.add(img, grain, dtype=cv2.CV_8U)
    return img, shapes


def jpeg(img: np.ndarray) -> bytes:
    """An RGB frame as a dataset stores it: cv2's JPEG at its default
    quality."""
    import cv2
    ok, buf = cv2.imencode('.jpg', np.ascontiguousarray(img[..., ::-1]))
    if not ok:
        raise RuntimeError('jpeg encode failed')
    return buf.tobytes()


def decode(content: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3], as the port's ETL decodes them."""
    import cv2
    bgr = cv2.imdecode(np.frombuffer(content, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
