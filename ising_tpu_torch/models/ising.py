"""2D Ising acceptance tables and exact results (host numpy).

A copy of the host-side part of ``ising_tpu/models/ising.py``: the port
must consume the identical integer thresholds, so these functions are the
same float64 arithmetic, line for line.

  * Spins are bits b in {0,1}; the physical spin is s = 2b - 1.
  * A flip changes the energy by dE = 2*(2b-1)*(2n-4), n = neighbor bit sum.
  * The flip is accepted when the raw uint32 draw r <= thr[b*5 + n],
    thr = rint(min(p, 1) * (2^32 - 1)).
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import TCRIT


def acceptance_probabilities(temp: float, field: float = 0.0) -> np.ndarray:
    """Float64 p[b][n] = exp(-dE/T); T <= 0 is the greedy quench (accept
    iff dE < 0, coin-flip on dE == 0)."""
    p = np.empty((2, 5), dtype=np.float64)
    for b in range(2):
        for n in range(5):
            de = 2.0 * (2 * b - 1) * ((2 * n - 4) + field)
            if temp > 0.0:
                p[b, n] = math.exp(-de / temp)
            else:
                p[b, n] = 1.0 if de < 0 else (0.5 if de == 0 else 0.0)
    return p


def threshold_table(temp: float, field: float = 0.0) -> np.ndarray:
    """uint32 acceptance thresholds, shape (10,) = [b*5 + n]; accept <=>
    draw <= thr. The bit1 sweep reads entries 7 (greedy dE == 0 coin),
    8 (dE = 4) and 9 (dE = 8)."""
    p = acceptance_probabilities(temp, field)
    thr = np.minimum(p, 1.0) * 4294967295.0
    return np.rint(thr).astype(np.uint64).astype(np.uint32).reshape(10)


def onsager_magnetization(temp: float) -> float:
    """Exact spontaneous |magnetization| of the infinite 2D lattice."""
    if temp <= 0:
        return 1.0
    if temp >= TCRIT:
        return 0.0
    x = math.sinh(2.0 / temp)
    return (1.0 - x ** -4) ** 0.125


def _ellipk_agm(k: float) -> float:
    """Complete elliptic integral K(k) (modulus k) via the AGM iteration."""
    k = min(max(k, 0.0), 1.0 - 1e-15)
    a, b = 1.0, math.sqrt(1.0 - k * k)
    for _ in range(60):
        if abs(a - b) < 1e-17 * a:
            break
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return math.pi / (2.0 * a)


def onsager_energy(temp: float) -> float:
    """Exact internal energy per spin U(T) of the infinite 2D lattice."""
    beta2 = 2.0 / temp
    th = math.tanh(beta2)
    coth = 1.0 / th
    k = 2.0 * math.sinh(beta2) / (math.cosh(beta2) ** 2)
    K = _ellipk_agm(k)
    return -coth * (1.0 + (2.0 / math.pi) * (2.0 * th * th - 1.0) * K)
