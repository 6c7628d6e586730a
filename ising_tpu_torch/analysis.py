"""Statistical analysis over replica ensembles: Binder cumulant, moments.

The port of ``ising_tpu/analysis.py``: the same functions, each formula in
float64 numpy in the same order of operations, so that every result
equals the JAX package's bit for bit. Inputs may be torch tensors, on any
device: they are taken to the host as numpy at the boundary.

The target workload named in SURVEY.md §7.5 / BASELINE.json ("Binder-cumulant
Tc sweep"): run many independent sub-lattice replicas per temperature
(reference replica mode, optimized/README.md:143-199), collect per-replica
magnetization moments, and locate the critical temperature from the Binder
cumulant U4 = 1 - <m^4> / (3 <m^2>^2), whose curves for different lattice
sizes cross at Tc (examples/tc_sweep.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def to_host(x):
    """A torch tensor (on any device) as numpy; anything else as it is:
    the boundary of this module and of reweight.py."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


@dataclasses.dataclass
class MomentAccumulator:
    """Streaming accumulator of |m| moments over replicas and measurements."""

    n: int = 0
    s1: float = 0.0
    s2: float = 0.0
    s4: float = 0.0

    def add(self, ms: np.ndarray) -> None:
        ms = np.asarray(to_host(ms), np.float64)
        self.n += ms.size
        self.s1 += float(np.sum(ms))
        self.s2 += float(np.sum(ms ** 2))
        self.s4 += float(np.sum(ms ** 4))

    @property
    def mean(self) -> float:
        return self.s1 / self.n if self.n else float("nan")

    @property
    def m2(self) -> float:
        return self.s2 / self.n if self.n else float("nan")

    @property
    def m4(self) -> float:
        return self.s4 / self.n if self.n else float("nan")

    def binder_cumulant(self) -> float:
        """U4 = 1 - <m^4>/(3 <m^2>^2); -> 2/3 ordered, -> 0 disordered."""
        if self.n == 0 or self.m2 == 0.0:
            return float("nan")
        return 1.0 - self.m4 / (3.0 * self.m2 ** 2)

    def susceptibility(self, nspins: int, temp: float) -> float:
        """chi = N (<m^2> - <|m|>^2) / T."""
        return nspins * (self.m2 - self.mean ** 2) / temp


    def specific_heat(self, nspins: int, temp: float) -> float:
        """C/N = N (<e^2> - <e>^2) / T^2 for per-spin samples e = E/N.

        Feed per-spin energies through add() (s2/s1 then hold energy
        moments; binder_cumulant is meaningless for that accumulator —
        keep separate accumulators for |m| and e).
        """
        return nspins * (self.m2 - self.mean ** 2) / temp ** 2


def binder_u4(samples) -> float:
    """U4 = 1 - <m^4>/(3 <m^2>^2) of a sample array — the functional form
    jackknife() needs (MomentAccumulator.binder_cumulant is the streaming
    twin; keep the formula in one place)."""
    s = np.asarray(to_host(samples), np.float64)
    m2 = float(np.mean(s ** 2))
    if s.size == 0 or m2 == 0.0:
        return float("nan")
    return 1.0 - float(np.mean(s ** 4)) / (3.0 * m2 * m2)


def autocorrelation_time(series, c: float = 6.0) -> tuple[float, int]:
    """Integrated autocorrelation time of an MC time series, with the
    Madras-Sokal automatic window (J. Stat. Phys. 50, 109 (1988), §3;
    standard practice for Metropolis observables near T_c where naive
    error bars are wrong by a factor sqrt(2 tau)).

    tau_int = 1/2 + sum_{t=1..W} rho(t), with the self-consistent window
    W = min { t : t >= c * tau_int(t) }. Returns (tau_int, W). For an
    uncorrelated series tau_int -> 1/2; the effective number of
    independent samples is n / (2 tau_int).
    """
    x = np.asarray(to_host(series), np.float64)
    n = x.size
    if n < 8:
        raise ValueError("need at least 8 samples")
    x = x - x.mean()
    var = float(np.dot(x, x)) / n
    if var == 0.0:
        return 0.5, 0
    # FFT autocovariance (O(n log n); series from long runs are big)
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n] / n
    rho = acov / acov[0]
    tau = 0.5
    for t in range(1, n):
        tau += float(rho[t])
        if t >= c * tau:
            return max(tau, 0.5), t
    return max(tau, 0.5), n - 1


def binned_error(series, nbins: int = 32) -> float:
    """Standard error of the mean from non-overlapping bin averages.

    Binning absorbs autocorrelation once the bin length exceeds ~2 tau;
    the classic convergence check is that this estimate plateaus as bins
    coarsen. nbins is capped so every bin holds >= 2 samples (1-sample
    bins would silently degrade to the naive autocorrelation-blind SEM —
    the estimate this function exists to replace); at least 2 bins must
    remain.
    """
    x = np.asarray(to_host(series), np.float64)
    nbins = min(nbins, x.size // 2)
    if nbins < 2:
        raise ValueError("need at least 4 samples (2 bins of >= 2)")
    nb = x.size // nbins
    b = x[:nb * nbins].reshape(nbins, nb).mean(axis=1)
    return float(b.std(ddof=1) / np.sqrt(nbins))


def jackknife(samples, statistic) -> tuple[float, float]:
    """Leave-one-out jackknife estimate and standard error of an arbitrary
    statistic over independent samples (e.g. replica measurements): the
    right error bar for NONLINEAR statistics like U4 or chi, where the
    naive error of a ratio of moments is biased.
    """
    s = np.asarray(to_host(samples), np.float64)
    n = s.shape[0]
    if n < 2:
        raise ValueError("need at least 2 samples")
    full = float(statistic(s))
    loo = np.array([statistic(np.delete(s, i, axis=0)) for i in range(n)],
                   np.float64)
    err = np.sqrt((n - 1) / n * np.sum((loo - loo.mean()) ** 2))
    est = n * full - (n - 1) * loo.mean()  # bias-corrected
    return float(est), float(err)


def jackknife_binder_u4(samples) -> tuple[float, float]:
    """jackknife(samples, binder_u4) over axis 0 of samples (n, ...) in
    O(n m) rather than O(n^2 m): each leave-one-out <m^2> and <m^4> is the
    total less the left-out sample's own sum, where jackknife() sums the
    n - 1 others anew (minutes at 16384 replicas). The same estimate and
    error up to rounding (the sums run in another order), not bit for
    bit; a leave-one-out <m^2> of 0 gives nan, as binder_u4 does."""
    s = np.asarray(to_host(samples), np.float64)
    n = s.shape[0]
    if n < 2:
        raise ValueError("need at least 2 samples")
    full = binder_u4(s)
    flat = s.reshape(n, -1)
    r2 = np.sum(flat ** 2, axis=1)
    r4 = np.sum(flat ** 4, axis=1)
    count = (n - 1) * flat.shape[1]
    m2 = (np.sum(r2) - r2) / count
    m4 = (np.sum(r4) - r4) / count
    with np.errstate(divide="ignore", invalid="ignore"):
        loo = np.where(m2 == 0.0, np.nan, 1.0 - m4 / (3.0 * m2 * m2))
    err = np.sqrt((n - 1) / n * np.sum((loo - loo.mean()) ** 2))
    est = n * full - (n - 1) * loo.mean()
    return float(est), float(err)


def kmin_mag2(line_counts, n_per_line: int) -> float:
    """|m(k1)|^2: squared Fourier magnetization at the smallest wavevector.

    line_counts[x] is the exact up-spin count of lattice line x along the
    chosen axis (observables.col_up_counts for k along columns,
    row_up_counts for k along rows); n_per_line the number of spins per
    line. With per-line spin sums S[x] = 2*c[x] - n_per_line and
    k1 = 2*pi/L, returns |sum_x e^{-i k1 x} S[x]|^2 — identical to
    |FFT2(s)[0, 1]|^2 (k along x) / |FFT2(s)[1, 0]|^2 (k along y) of the
    full +-1 plane, at O(L) host cost from integer partials instead of an
    O(N log N) FFT of a materialized plane.
    """
    c = np.asarray(to_host(line_counts), np.float64)
    L = c.size
    s = 2.0 * c - float(n_per_line)
    mk = np.sum(s * np.exp((-2j * np.pi / L) * np.arange(L)))
    return float(mk.real ** 2 + mk.imag ** 2)


def second_moment_xi(m0sq: float, mksq: float, L: int) -> float:
    """Second-moment correlation length from ensemble-mean |m(k)|^2.

    xi_L = sqrt(<|m(0)|^2> / <|m(k1)|^2> - 1) / (2 sin(pi/L)), the standard
    finite-size estimator (Cooper-Freedman-Preston / Caracciolo et al.):
    exact for a free-field propagator, and xi_L/L curves for different L
    cross at Tc like the Binder cumulant. Inputs are UN-centered second
    moments (use it in the disordered phase or per-|m| sector); mksq <= 0
    (a perfectly k1-free configuration set) returns inf, and sampling
    noise that drives the bracket negative clamps to 0.
    """
    if not mksq > 0.0:
        return float("inf")
    return (math.sqrt(max(m0sq / mksq - 1.0, 0.0))
            / (2.0 * math.sin(math.pi / L)))


def correlation_length(m0sq_samples, mksq_samples, L: int):
    """(xi, err): jackknifed second-moment correlation length over paired
    per-measurement samples of |m(0)|^2 and |m(k1)|^2 (kmin_mag2)."""
    pairs = np.stack([np.asarray(to_host(m0sq_samples), np.float64),
                      np.asarray(to_host(mksq_samples), np.float64)], axis=1)
    return jackknife(pairs, lambda s: second_moment_xi(
        float(np.mean(s[:, 0])), float(np.mean(s[:, 1])), L))


def structure_factor(spins) -> np.ndarray:
    """S(k) = |FFT2(s)|^2 / N of a +-1 spin plane (host-side, for plane
    sizes worth materializing; the k1 entries reproduce kmin_mag2/N)."""
    s = np.asarray(to_host(spins), np.float64)
    f = np.fft.fft2(s)
    return (f.real ** 2 + f.imag ** 2) / s.size


def binder_crossing(temps, u4_by_size: dict[int, np.ndarray]) -> float:
    """Estimate Tc as the pairwise crossing of U4(T) curves for two sizes.

    Takes the two largest sizes and linearly interpolates the sign change of
    their difference; returns nan if they never cross in range.
    """
    sizes = sorted(u4_by_size)
    if len(sizes) < 2:
        raise ValueError("need at least two lattice sizes")
    a = np.asarray(to_host(u4_by_size[sizes[-2]]), np.float64)
    b = np.asarray(to_host(u4_by_size[sizes[-1]]), np.float64)
    d = a - b
    t = np.asarray(to_host(temps), np.float64)
    for i in range(len(t) - 1):
        if d[i] == 0.0:
            return float(t[i])
        if d[i] * d[i + 1] < 0:
            f = d[i] / (d[i] - d[i + 1])
            return float(t[i] + f * (t[i + 1] - t[i]))
    return float("nan")


def binder_g(q_samples) -> float:
    """Spin-glass Binder ratio g = (3 - <q^4>/<q^2>^2) / 2 over replica-
    overlap samples (Simulation.overlap_with / tempering.replica_overlap):
    -> 1 in the frozen phase (P(q) peaked at +-q_EA), -> 0 in the
    paramagnet (Gaussian P(q)); curves for different sizes cross at T_SG.
    Jackknife-compatible like binder_u4 (pass this to jackknife())."""
    q = np.asarray(to_host(q_samples), np.float64)
    if q.size == 0:
        return float("nan")
    m2 = float(np.mean(q ** 2))
    if m2 == 0.0:
        return float("nan")
    return 0.5 * (3.0 - float(np.mean(q ** 4)) / (m2 * m2))


def _scaled_sets(data, tc: float, nu: float, zeta: float):
    sets = []
    for L, (temps, y, dy) in sorted(data.items()):
        t = np.asarray(to_host(temps), np.float64)
        yy = np.asarray(to_host(y), np.float64)
        ee = np.asarray(to_host(dy), np.float64)
        if not (t.shape == yy.shape == ee.shape):
            raise ValueError(f"L={L}: temps/y/dy must align")
        if np.any(ee <= 0):
            raise ValueError(f"L={L}: error bars must be > 0")
        s = float(L) ** (-zeta)
        sets.append(((t - tc) * float(L) ** (1.0 / nu), yy * s, ee * s))
    return sets


def collapse_quality(data, tc: float, nu: float, zeta: float = 0.0) -> float:
    """Quality S of a finite-size scaling collapse (Houdayer & Hartmann,
    PRB 70, 014418 (2004) — the standard objective, cf. pyfssa).

    data: {L: (temps, y, dy)} measured curves with error bars, one per
    lattice size. Each point is scaled to x = (T - Tc) L^(1/nu),
    y' = y L^(-zeta) (zeta = 0 for dimensionless observables like U4,
    g, xi_L/L; gamma/nu for chi). For every point the master curve is
    estimated by an error-weighted linear fit through the bracketing
    points of the OTHER sizes, and S is the mean squared deviation in
    units of the combined uncertainty: S ~ 1 at the true parameters,
    growing as the collapse degrades. Points whose x falls outside every
    other size's range are skipped (ends of the window).
    """
    if len(data) < 2:
        raise ValueError("need curves for at least two lattice sizes")
    sets = _scaled_sets(data, tc, nu, zeta)
    total, count = 0.0, 0
    for i, (xi, yi, ei) in enumerate(sets):
        for xj, yj, ej in zip(xi, yi, ei):
            sx, sy, sw = [], [], []
            for i2, (x2, y2, e2) in enumerate(sets):
                if i2 == i:
                    continue
                below = np.flatnonzero(x2 <= xj)
                above = np.flatnonzero(x2 >= xj)
                if not (below.size and above.size):
                    continue  # this size does not bracket xj: no
                    # one-sided extrapolation from far-away points
                for idx in {below[np.argmax(x2[below])],
                            above[np.argmin(x2[above])]}:
                    sx.append(x2[idx])
                    sy.append(y2[idx])
                    sw.append(1.0 / (e2[idx] * e2[idx]))
            if len(sx) < 2:
                continue
            sx = np.asarray(sx)
            sy = np.asarray(sy)
            sw = np.asarray(sw)
            K, Kx, Ky = sw.sum(), (sw * sx).sum(), (sw * sy).sum()
            Kxx, Kxy = (sw * sx * sx).sum(), (sw * sx * sy).sum()
            delta = K * Kxx - Kx * Kx
            if delta <= 0:
                continue
            yhat = (Kxx * Ky - Kx * Kxy + xj * (K * Kxy - Kx * Ky)) / delta
            var = (Kxx - 2.0 * xj * Kx + xj * xj * K) / delta
            total += (yj - yhat) ** 2 / (ej * ej + var)
            count += 1
    if count == 0:
        raise ValueError("no overlapping scaled windows between sizes — "
                         "the temperature ranges do not collapse onto a "
                         "common x interval at these parameters")
    return total / count


def fit_collapse(data, tc0: float, nu0: float, zeta0: float | None = None,
                 errors: bool = False, tc_bounds=None,
                 nu_bounds=(0.2, 10.0)):
    """Minimize collapse_quality over (Tc, nu[, zeta]) by Nelder-Mead.

    Returns {"tc", "nu", ("zeta",) "quality"(, "tc_err", "nu_err",
    "zeta_err")}. Error bars (errors=True) are the Houdayer-Hartmann
    one-parameter half-widths where S crosses S_min + 1 (mean of the up
    and down crossings, found by bisection with the other parameters
    fixed at the optimum); inf marks a direction S never constrains.

    The search is BOUNDED: tc within the sampled temperature window by
    default (a crossing outside the data cannot be measured, and S has a
    degenerate minimum at |Tc| -> inf with nu -> inf where every scaled
    window collapses trivially — observed on noisy two-size data), nu
    within a generous physical range. Pass explicit bounds to widen.
    """
    from scipy.optimize import minimize
    if tc_bounds is None:
        all_t = np.concatenate([np.asarray(to_host(v[0]), np.float64)
                                for v in data.values()])
        tc_bounds = (float(all_t.min()), float(all_t.max()))
    fit_zeta = zeta0 is not None
    p0 = [min(max(tc0, tc_bounds[0]), tc_bounds[1]),
          min(max(nu0, nu_bounds[0]), nu_bounds[1])] \
        + ([zeta0] if fit_zeta else [])

    def S(p):
        if not (tc_bounds[0] <= p[0] <= tc_bounds[1]
                and nu_bounds[0] <= p[1] <= nu_bounds[1]):
            return 1e30
        try:
            return collapse_quality(data, p[0], p[1],
                                    p[2] if fit_zeta else 0.0)
        except ValueError:
            return 1e30   # windows stopped overlapping: reject the step

    res = minimize(S, p0, method="Nelder-Mead",
                   options={"xatol": 1e-6, "fatol": 1e-9, "maxiter": 2000})
    out = {"tc": float(res.x[0]), "nu": float(res.x[1]),
           "quality": float(res.fun)}
    if fit_zeta:
        out["zeta"] = float(res.x[2])
    if errors:
        smin = res.fun

        def half_width(k, sign):
            """Distance from the optimum to the S = S_min + 1 crossing in
            one direction; inf when S never crosses (the parameter is
            unconstrained that way — report it, don't fake a width)."""
            step = max(0.01 * abs(res.x[k]), 1e-3)
            hi = step
            while S(np.r_[res.x[:k], res.x[k] + sign * hi,
                          res.x[k + 1:]]) < smin + 1.0:
                hi *= 2.0
                if hi > 1e3:
                    return float("inf")
            lo = 0.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if S(np.r_[res.x[:k], res.x[k] + sign * mid,
                           res.x[k + 1:]]) < smin + 1.0:
                    lo = mid
                else:
                    hi = mid
            return 0.5 * (lo + hi)

        for k, name in enumerate(["tc", "nu"] + (["zeta"] if fit_zeta
                                                 else [])):
            up, dn = half_width(k, +1.0), half_width(k, -1.0)
            # symmetric one-sigma analog: mean of the two half-widths;
            # inf survives the mean, flagging an unconstrained direction
            out[name + "_err"] = 0.5 * (up + dn)
    return out


def binder_g_disorder(q2_by_realization, q4_by_realization):
    """(g, err): disorder-averaged overlap Binder ratio
    g = (3 - [<q^4>]_av / [<q^2>]_av^2) / 2 with jackknife errors over
    REALIZATIONS. The correct spin-glass estimator: thermal moments are
    averaged over disorder BEFORE the ratio is taken (a per-realization
    binder_g averaged afterwards is a different, biased quantity), and
    realization-to-realization scatter — not thermal noise — dominates
    the error, so the jackknife resamples the disorder axis. Inputs are
    per-realization thermal means of q^2 and q^4 (from
    tempering.replica_overlap samples at one rung)."""
    q2 = np.asarray(to_host(q2_by_realization), np.float64)
    q4 = np.asarray(to_host(q4_by_realization), np.float64)
    if q2.shape != q4.shape:
        raise ValueError("need paired per-realization <q^2> and <q^4>")
    pairs = np.stack([q2, q4], axis=1)
    return jackknife(pairs, lambda s: 0.5 * (
        3.0 - float(np.mean(s[:, 1])) / float(np.mean(s[:, 0])) ** 2))
