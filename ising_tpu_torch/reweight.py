"""Histogram reweighting: evaluate observables at temperatures you never
simulated.

The port of ``ising_tpu/reweight.py``: the same estimators, each in
float64 numpy in the same order of operations (the log-space sums, the
ratio form of the weighted mean), so that every result and every
ValueError equals the JAX package's. Inputs may be torch tensors, on any
device: they are taken to the host as numpy at the boundary.

Single-histogram reweighting (Ferrenberg & Swendsen, PRL 61, 2635 (1988))
turns one run at T0 into <O>(T) for every T in the overlap window of the
sampled energy distribution; the multiple-histogram method / WHAM
(Ferrenberg & Swendsen, PRL 63, 1195 (1989)) stitches runs at several
temperatures into one continuous estimator. This is the natural
post-processor for the parallel-tempering ladder (tempering.py): a PT run
already holds equilibrated samples at K temperatures, and WHAM converts
them into smooth <E>(T), C(T), chi(T) curves and sharp peak locations —
something the reference's fixed temperature grid cannot do at all
(optimized/main.cu:1095-1110 prints observables only at the simulated
temperature).

All estimators work on RAW per-measurement samples rather than binned
histograms: for the Ising model the energy support is discrete and modest,
but raw-sample WHAM is exactly the infinitesimal-bin limit and avoids the
binning-width systematic entirely. Everything is log-space (log-sum-exp)
so absolute energies of giant lattices (|E| ~ 1e10) cannot overflow.

Units: energies are TOTAL Hamiltonians H (e.g. `-Simulation.energy_total()`
or tempering.measure()'s "hamiltonian" — NOT the per-spin energy());
temperatures are in units of J/k_B like everywhere else in the package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .analysis import to_host

__all__ = [
    "effective_sample_size",
    "reweight",
    "reweight_curve",
    "Wham",
    "wham",
    "wham_jackknife",
    "peak_location",
]


def _logsumexp(a: np.ndarray, axis=None):
    """log(sum(exp(a))) without overflow; -inf-safe."""
    amax = np.max(a, axis=axis, keepdims=True)
    amax = np.where(np.isfinite(amax), amax, 0.0)
    return (np.log(np.sum(np.exp(a - amax), axis=axis))
            + np.squeeze(amax, axis=axis))


def effective_sample_size(log_weights: np.ndarray) -> float:
    """Kish effective sample size of normalized importance weights:
    (sum w)^2 / sum w^2, computed from log-weights. The reliability
    gauge for any reweighted estimate — an extrapolation outside the
    sampled energy window shows up as ESS collapsing toward 1 long
    before the estimate visibly degrades.
    """
    lw = np.asarray(to_host(log_weights), np.float64)
    return float(np.exp(2.0 * _logsumexp(lw) - _logsumexp(2.0 * lw)))


def _weighted_mean(log_weights: np.ndarray, O: np.ndarray):
    """sum(w * O) / sum(w) from log-weights, as an explicit RATIO.

    Normalizing the weights first and assuming they sum to 1 leaves a
    ~1e-9 relative normalization residue that an observable with a large
    offset amplifies into an absolute error (offset * residue); the ratio
    form cancels it (the +C shift test in test_reweight.py pins this).
    """
    w = np.exp(log_weights - np.max(log_weights))
    s = float(np.sum(w))
    w = w.reshape((O.shape[0],) + (1,) * (O.ndim - 1))
    return np.sum(w * O, axis=0) / s


def _log_weights_single(energies: np.ndarray, temp_from: float,
                        temp_to: float) -> np.ndarray:
    beta0 = 1.0 / temp_from
    beta1 = 1.0 / temp_to
    return -(beta1 - beta0) * energies


def reweight(energies, temp_from: float, temp_to: float,
             observable=None, min_ess: float = 10.0):
    """Single-histogram estimate of <O> at temp_to from samples at temp_from.

    energies: per-measurement TOTAL energies E_i of the run at temp_from.
    observable: per-measurement samples O_i aligned with energies (any
    trailing shape); None estimates <E> itself. Returns (estimate, ess);
    raises ValueError when the Kish effective sample size falls below
    min_ess — at that point the answer is dominated by a handful of tail
    configurations and is statistically meaningless, and silently
    returning it is how reweighting plots grow unphysical wiggles.
    """
    E = np.asarray(to_host(energies), np.float64).ravel()
    if E.size == 0:
        raise ValueError("need at least one sample")
    lw = _log_weights_single(E, temp_from, temp_to)
    ess = effective_sample_size(lw)
    if ess < min_ess:
        raise ValueError(
            f"reweighting {temp_from} -> {temp_to} leaves effective sample "
            f"size {ess:.2f} < {min_ess}; the runs do not overlap that far. "
            f"Sample closer to the target (or combine runs with wham()).")
    O = E if observable is None \
        else np.asarray(to_host(observable), np.float64)
    if O.shape[0] != E.size:
        raise ValueError("observable and energies must align on axis 0")
    out = _weighted_mean(lw, O)
    return (float(out) if np.ndim(out) == 0 else out), ess


def reweight_curve(energies, temp_from: float, temps,
                   observable=None, min_ess: float = 10.0):
    """Vector version of reweight() over a temperature grid.

    Returns (estimates, esses) arrays aligned with temps; grid points whose
    ESS falls below min_ess are nan rather than an exception, so a curve
    can honestly span past its own validity window and show where it ends.
    """
    E = np.asarray(to_host(energies), np.float64).ravel()
    if E.size == 0:
        raise ValueError("need at least one sample")
    O = E if observable is None \
        else np.asarray(to_host(observable), np.float64)
    if O.shape[0] != E.size:
        raise ValueError("observable and energies must align on axis 0")
    if O.ndim > 1:
        raise ValueError("reweight_curve builds scalar curves; use "
                         "reweight() per temperature for array observables")
    temps = np.asarray(to_host(temps), np.float64)
    est = np.full(temps.shape, np.nan)
    ess = np.zeros(temps.shape)
    for i, t in enumerate(temps.ravel()):
        lw = _log_weights_single(E, temp_from, float(t))
        s = effective_sample_size(lw)
        ess.ravel()[i] = s
        if s >= min_ess:  # low-ESS points stay nan, no exception
            est.ravel()[i] = float(_weighted_mean(lw, O))
    return est, ess


@dataclasses.dataclass(frozen=True)
class Wham:
    """Solved multiple-histogram ensemble: pooled samples + free energies.

    Produced by wham(); query with expectation()/moments()/ess(). The
    pooled log-denominator log sum_k n_k exp(f_k - beta_k E_j) is
    precomputed once, so each temperature query is one O(n_samples) pass.
    """

    energies: np.ndarray       # pooled E_j, shape (n,)
    log_denom: np.ndarray      # log sum_k n_k exp(f_k - beta_k E_j), (n,)
    temps: np.ndarray          # the K run temperatures
    free_energies: np.ndarray  # f_k = -log Z_k relative to f_0 = 0
    iterations: int
    residual: float

    def log_weights(self, temp: float) -> np.ndarray:
        """Un-normalized log sample weights at inverse temperature 1/temp."""
        return -self.energies / temp - self.log_denom

    def ess(self, temp: float) -> float:
        return effective_sample_size(self.log_weights(temp))

    def expectation(self, temp: float, observable=None,
                    min_ess: float = 10.0):
        """<O>(temp) over the pooled ensemble; O defaults to the energy.

        observable must align with the CONCATENATED sample order the
        ensemble was built from (run 0's samples, then run 1's, ...).
        """
        lw = self.log_weights(temp)
        ess = effective_sample_size(lw)
        if ess < min_ess:
            raise ValueError(
                f"T={temp} has effective sample size {ess:.2f} < {min_ess}; "
                f"outside the ladder's overlap window "
                f"[{self.temps.min()}, {self.temps.max()}].")
        O = self.energies if observable is None \
            else np.asarray(to_host(observable), np.float64)
        if O.shape[0] != self.energies.size:
            raise ValueError("observable must align with pooled samples")
        out = _weighted_mean(lw, O)
        return (float(out) if np.ndim(out) == 0 else out), ess

    def energy_moments(self, temp: float,
                       min_ess: float = 10.0) -> tuple[float, float]:
        """(<E>, <E^2>) at temp — the specific-heat ingredients, from ONE
        weight pass (this sits inside golden-section/jackknife loops, so
        recomputing the logsumexp per moment would double the cost)."""
        lw = self.log_weights(temp)
        ess = effective_sample_size(lw)
        if ess < min_ess:
            raise ValueError(
                f"T={temp} has effective sample size {ess:.2f} < {min_ess}; "
                f"outside the ladder's overlap window "
                f"[{self.temps.min()}, {self.temps.max()}].")
        w = np.exp(lw - np.max(lw))
        s = float(np.sum(w))
        we = w * self.energies
        return float(np.sum(we)) / s, float(np.sum(we * self.energies)) / s

    def specific_heat(self, temp: float, nspins: int) -> float:
        """C/N = (<E^2> - <E>^2) / (N T^2) from the pooled ensemble."""
        e1, e2 = self.energy_moments(temp)
        return (e2 - e1 * e1) / (nspins * temp * temp)


def wham(energies_by_run, temps, tol: float = 1e-12,
         maxiter: int = 10_000, f_init=None) -> Wham:
    """Solve the WHAM self-consistency over runs at several temperatures.

    energies_by_run: sequence of per-run TOTAL-energy sample arrays (one
    per temperature; a PT run's per-rung energy series slots in directly).
    temps: the matching simulation temperatures. Iterates

        exp(-f_k) = sum_j exp(-beta_k E_j) / sum_m n_m exp(f_m - beta_m E_j)

    (the raw-sample / infinitesimal-bin form of Ferrenberg-Swendsen II)
    with f_0 pinned to 0, until max |delta f| < tol. Convergence is
    geometric when adjacent energy histograms overlap — the same condition
    a healthy PT ladder already satisfies by construction (its swap rates
    ARE the overlap). Raises if the iteration stalls above tol * 1e3.
    f_init warm-starts the free energies (wham_jackknife re-solves from
    the full-dataset solution).
    """
    temps = np.asarray(to_host(temps), np.float64)
    runs = [np.asarray(to_host(e), np.float64).ravel()
            for e in energies_by_run]
    if len(runs) != temps.size:
        raise ValueError("one energy series per temperature")
    if len(runs) < 2:
        raise ValueError("wham needs >= 2 runs; use reweight() for one")
    if any(r.size == 0 for r in runs):
        raise ValueError("empty energy series")
    n_k = np.array([r.size for r in runs], np.float64)
    E = np.concatenate(runs)                       # pooled samples, (n,)
    betas = 1.0 / temps                            # (K,)
    # (K, n) matrix of -beta_k E_j, the only big intermediate. For very
    # long ladders x runs this is K*n doubles — chunk if it ever matters.
    negBE = -np.outer(betas, E)
    if f_init is None:
        f = np.zeros(temps.size)
    else:
        f = np.asarray(to_host(f_init), np.float64).copy()
        if f.shape != temps.shape:
            raise ValueError("f_init must have one entry per temperature")
        f = f - f[0]
    it = 0
    resid = math.inf
    for it in range(1, maxiter + 1):
        # log denom_j = log sum_m n_m exp(f_m - beta_m E_j)
        log_denom = _logsumexp(negBE + (f + np.log(n_k))[:, None], axis=0)
        # log exp(-f_k^new) = logsumexp_j(-beta_k E_j - log denom_j)
        f_new = -_logsumexp(negBE - log_denom[None, :], axis=1)
        f_new = f_new - f_new[0]
        resid = float(np.max(np.abs(f_new - f)))
        f = f_new
        if resid < tol:
            break
    if resid > tol * 1e3:
        raise ValueError(
            f"WHAM failed to converge: residual {resid:.3e} after {it} "
            f"iterations — adjacent temperatures likely do not overlap.")
    log_denom = _logsumexp(negBE + (f + np.log(n_k))[:, None], axis=0)
    return Wham(energies=E, log_denom=log_denom, temps=temps,
                free_energies=f, iterations=it, residual=resid)


def wham_jackknife(energies_by_run, temps, statistic, nblocks: int = 10,
                   observables_by_run=None, **wham_kw):
    """(estimate, error) of a functional of the WHAM ensemble by block
    jackknife: delete one TIME block from every run simultaneously,
    re-solve the self-consistency (warm-started from the full solution),
    and propagate the spread — the honest error bar for reweighted
    curves, absorbing both the free-energy refit and MC autocorrelation
    once blocks exceed ~2 tau (the same blocking logic as
    analysis.binned_error; jackknife formulae as analysis.jackknife).

    statistic: callable(Wham) -> float, e.g.
        lambda ens: ens.specific_heat(2.3, N)
        lambda ens: peak_location(lambda t: ens.specific_heat(t, N),
                                  tlo, thi)[0]
    With observables_by_run (per-run arrays aligned with each energy
    series), statistic is called as statistic(ens, pooled_obs) where
    pooled_obs matches the resampled ensemble's sample order — for
    magnetization-based functionals like chi(T).
    """
    runs = [np.asarray(to_host(r), np.float64).ravel()
            for r in energies_by_run]
    if nblocks < 2:
        raise ValueError("need at least 2 blocks")
    if min(r.size for r in runs) < 2 * nblocks:
        raise ValueError("need >= 2 samples per block in every run")
    obs = None
    if observables_by_run is not None:
        obs = [np.asarray(to_host(o), np.float64) for o in observables_by_run]
        if len(obs) != len(runs) or any(
                o.shape[0] != r.size for o, r in zip(obs, runs)):
            raise ValueError("observables must align with energy runs")

    def solve(drop, f_init=None):
        keep = []
        for r in runs:
            nb = r.size // nblocks
            m = np.ones(r.size, bool)
            if drop is not None:
                m[drop * nb:(drop + 1) * nb] = False
            keep.append(m)
        ens = wham([r[m] for r, m in zip(runs, keep)], temps,
                   f_init=f_init, **wham_kw)
        if obs is not None:
            pooled = np.concatenate([o[m] for o, m in zip(obs, keep)])
            return float(statistic(ens, pooled)), ens
        return float(statistic(ens)), ens

    full, ens0 = solve(None)
    loo = np.array([solve(b, f_init=ens0.free_energies)[0]
                    for b in range(nblocks)])
    err = math.sqrt((nblocks - 1) / nblocks
                    * float(np.sum((loo - loo.mean()) ** 2)))
    est = nblocks * full - (nblocks - 1) * float(loo.mean())
    return est, err


def peak_location(curve, lo: float, hi: float, tol: float = 1e-6,
                  maxiter: int = 200) -> tuple[float, float]:
    """(argmax, max) of a smooth scalar curve on [lo, hi] by golden-section.

    The reweighting use case: curve = lambda T: ens.specific_heat(T, N)
    locates the pseudo-critical temperature of a finite lattice to far
    better resolution than any simulated temperature grid.
    """
    if not hi > lo:
        raise ValueError("need hi > lo")
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = float(lo), float(hi)
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = curve(c), curve(d)
    for _ in range(maxiter):
        if b - a < tol:
            break
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = curve(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = curve(d)
    x = (a + b) / 2.0
    return x, float(curve(x))
