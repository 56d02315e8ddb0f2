"""The yardstick of the kernels and the card: published peaks of one
NVIDIA H100 (SXM, dense, at its 700 W limit) and the benchmark's own count
of each kernel's operation: the operations and bytes the operation needs at
its shapes, whatever the kernel does. Each input byte is read once and each
output byte written once."""
from __future__ import annotations

from typing import Tuple

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bfloat16 tensor cores, dense


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the float32 rate."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS)


def band_groupnorm(n: int, q: int, c: int, itemsize: int,
                   relu: bool) -> Tuple[float, float]:
    """Flat-band GroupNorm of [N, Q, C]: read x, write y, read the [C]
    scale and bias; per element a sum and a square-sum (3 operations),
    normalize (2) and the affine (2), and the ReLU (1)."""
    e = n * q * c
    return e * (7 + relu), 2 * e * itemsize + 2 * c * 4


def band_groupnorm_backward(n: int, q: int, c: int, itemsize: int,
                            relu: bool) -> Tuple[float, float]:
    """Its gradient: read x and dy, write dx, read scale, write dscale and
    dbias; per element the statistics again (3), x-hat (2), g (1), the two
    band means (4), dx (3), the per-channel sums (2) and the ReLU mask
    (1)."""
    e = n * q * c
    return e * (15 + relu), 3 * e * itemsize + 3 * c * 4


def segment_topk(rows: int, n: int, cap: int, m: int) -> Tuple[float, float]:
    """Per-segment top-``cap`` of ``rows`` float32 score rows of ``n``,
    cut into s = ceil(n / m) segments: read every score once (one
    comparison each), write ``cap`` (value, index) pairs a segment."""
    s = -(-n // m)
    return rows * n, rows * n * 4 + rows * cap * s * 8


def nms_keep(r: int, k: int) -> Tuple[float, float]:
    """Greedy NMS over R sets of K score-sorted boxes: the IoU of each pair
    once (about 12 operations: two areas, the intersection's four bounds,
    its area, the union and the comparison), read the boxes and flags,
    write the keep flags."""
    return r * k * (k - 1) / 2 * 12, r * k * (16 + 1 + 1)
