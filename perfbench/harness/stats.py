"""Order statistics and error measures, on plain Python numbers and
tensors."""
from __future__ import annotations

import statistics
from typing import Sequence


def median(values: Sequence[float]) -> float:
    return float(statistics.median(values))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)


def nrmse(got, want) -> float:
    """Root mean square of ``got - want`` over the root mean square
    spread of ``want`` about its mean (float64): scale-free, so a tensor
    that varies little about a large offset (the forced-dense class
    scores) is judged by its variation."""
    g = got.detach().double()
    w = want.detach().double()
    err = (g - w).square().mean().sqrt()
    scale = (w - w.mean()).square().mean().sqrt()
    return float(err / scale.clamp(min=1e-30))
