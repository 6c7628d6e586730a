"""2D Ising acceptance tables, exact results and disorder links.

A copy of ``ising_tpu/models/ising.py``: the port must consume the
identical integer thresholds, so the host functions are the same float64
arithmetic, line for line; the quenched disorder links are drawn in torch
from the same Philox stream.

  * Spins are bits b in {0,1}; the physical spin is s = 2b - 1.
  * A flip changes the energy by dE = 2*(2b-1)*(2n-4), n = neighbor bit sum.
  * The flip is accepted when the raw uint32 draw r <= thr[b*5 + n],
    thr = rint(min(p, 1) * (2^32 - 1)).
  * The bit-plane modes accept when a k-bit uniform v < t, t = rint(p * 2^k)
    (bernoulli_kbit_thresholds, field_kbit_thresholds).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import TCRIT
from ..rng import TAG_HAMILT, color_draws


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


def bernoulli_kbit_thresholds(temp: float, kbits: int = 24) -> tuple[int, int]:
    """K-bit integer thresholds (t4, t8) for the bit-serial accept path.

    Used by the bit1 backend's hw mode: accept <=> v < t, where v is a
    k-bit uniform assembled from k independent random bit-planes and the
    comparison is evaluated bit-serially on whole planes. t = rint(p * 2^k)
    (clipped to 2^k - 1), so the realized flip probability t/2^k deviates
    from exp(-dE/T) by at most 2^-(k+1) — except when the clip engages
    (p > 1 - 2^-(k+1), i.e. extremely high T), where the deviation is
    bounded by 2^-k and exact always-accept is never reached for the
    stochastic classes. At the default k = 24 this is the
    same granularity as the reference's acceptance compare, whose
    curand_uniform draws live on a 2^-24 grid (optimized/main.cu:652-656).

    (t4, t8) are the thresholds of the two stochastic classes dE = 4 and
    dE = 8; every dE <= 0 class always accepts, handled by the class masks.
    """
    p = acceptance_probabilities(temp)
    cap = (1 << kbits) - 1
    t4 = min(cap, int(np.rint(min(p[1, 3], 1.0) * (1 << kbits))))
    t8 = min(cap, int(np.rint(min(p[1, 4], 1.0) * (1 << kbits))))
    return t4, t8


def field_kbit_thresholds(temp: float, field: float,
                          kbits: int = 16) -> tuple[tuple, int]:
    """Static k-bit acceptance for the 10-class bit-serial field accept.

    Returns (tvals10, always10) consumed by the bit1 kernel's
    _bitserial_field_flip and the xla backend's plane-mode field path:

      * tvals10[b*5 + n] = rint(p * 2^k) clipped to 2^k - 1 for classes
        with p < 1 — the flip fires iff the assembled k-bit uniform
        v < t (STRICT compare, same convention as
        bernoulli_kbit_thresholds' h = 0 chains);
      * always10 bit (b*5 + n) set when p >= 1 (deterministic flip;
        such classes consume no threshold);
      * p rounding to 0 leaves t = 0: the class never flips.

    h != 0 breaks the mirror symmetry behind the h = 0 two-threshold
    accept, so all ten (own bit, neighbor count) classes carry their own
    static threshold. The table also covers T <= 0 (greedy quench with
    field: p in {0, 0.5, 1}), so the field path needs no greedy branch.
    Reference analog: none — the reference has no field term; the h = 0
    granularity discussion in bernoulli_kbit_thresholds applies per class.
    """
    p = acceptance_probabilities(temp, field)
    cap = (1 << kbits) - 1
    tvals = []
    always = 0
    for b in range(2):
        for n in range(5):
            pf = p[b, n]
            if pf >= 1.0:
                always |= 1 << (b * 5 + n)
                tvals.append(0)
            else:
                tvals.append(min(cap, int(np.rint(pf * (1 << kbits)))))
    return tuple(tvals), always


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


def generate_disorder_links(seed: int, nrows: int, ncols: int, prob: float,
                            *, row0: int = 0, local_rows: int | None = None,
                            device="cpu"):
    """Quenched +-J disorder: Bernoulli(prob) antiferromagnetic link flags.

    Returns (v, h) uint8 full-lattice planes of shape (rows, ncols):
      v[y, x] = 1 if the vertical link (y,x)-(y+1 mod Y, x) is antiferro,
      h[y, x] = 1 if the horizontal link (y,x)-(y, x+1 mod X) is antiferro.

    One Philox-10 u32 draw per link, whatever the sweep's rng mode: v from
    tag TAG_HAMILT | 0, h from TAG_HAMILT | 1, over the full width
    (row_stride = ncols); flag = (draw & 0xFFFF) < round(prob * 2^16).
    row0/local_rows carve out a row slab of the same stream, so chunked
    generation is bit-identical to one-shot.
    """
    cut = int(round(prob * 65536.0))
    rows = local_rows if local_rows is not None else nrows
    out = []
    for tag in (TAG_HAMILT | 0, TAG_HAMILT | 1):
        d = color_draws(seed, rows, ncols, step=0, tag=tag, row0=row0,
                        row_stride=ncols, device=device)
        out.append(((d & 0xFFFF) < cut).to(torch.uint8))
        del d
    return out[0], out[1]
