"""The port's reweight module against the JAX package's, at tolerance 0:
every estimator on the same samples (drawn from a seed with numpy from the
exact Boltzmann distribution of a 2 x 8 lattice) returns the same floats
and raises the same ValueErrors, word for word. Torch tensors are taken
as inputs too."""

import numpy as np
import pytest
import torch

from ising_tpu import reweight as jr
from ising_tpu_torch import reweight as tr

Y, X = 2, 8
N = Y * X


def _all_states():
    states = ((np.arange(1 << N)[:, None] >> np.arange(N)) & 1)
    s = (2.0 * states - 1.0).reshape(-1, Y, X)
    bonds = ((s * np.roll(s, -1, axis=2)).sum(axis=(1, 2))
             + (s * np.roll(s, -1, axis=1)).sum(axis=(1, 2)))
    return -bonds, s.sum(axis=(1, 2))


H_ALL, M_ALL = _all_states()
TEMPS = (2.0, 2.3, 2.6)


def _draw(temp, n, seed):
    w = np.exp(-(H_ALL - H_ALL.min()) / temp)
    idx = np.random.default_rng(seed).choice(H_ALL.size, size=n,
                                             p=w / w.sum())
    return H_ALL[idx], M_ALL[idx]


RUNS = [_draw(t, 400, k) for k, t in enumerate(TEMPS)]
ENERGIES = [e for e, _ in RUNS]
MAGS = [np.abs(m) for _, m in RUNS]


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(a) is type(b)


def _errors_alike(fn_jax, fn_port):
    with pytest.raises(ValueError) as je:
        fn_jax()
    with pytest.raises(ValueError) as te:
        fn_port()
    assert str(te.value) == str(je.value)


def test_effective_sample_size_matches_jax():
    lw = np.random.default_rng(0).normal(0.0, 3.0, 500)
    _same(jr.effective_sample_size(lw), tr.effective_sample_size(lw))
    _same(jr.effective_sample_size(lw),
          tr.effective_sample_size(torch.from_numpy(lw)))
    for lw in (np.zeros(7), np.array([0.0, -np.inf, -np.inf]),
               np.array([1e300, 1e300])):
        _same(jr.effective_sample_size(lw), tr.effective_sample_size(lw))


@pytest.mark.parametrize("t_to", [2.0, 2.2, 2.45])
def test_reweight_matches_jax(t_to):
    E, M = RUNS[1]
    _same(jr.reweight(E, 2.3, t_to), tr.reweight(E, 2.3, t_to))
    _same(jr.reweight(E, 2.3, t_to, observable=M ** 2),
          tr.reweight(torch.from_numpy(E), 2.3, t_to,
                      observable=torch.from_numpy(M ** 2)))
    obs = np.stack([M, M ** 2, E + 1e6], axis=1)
    _same(jr.reweight(E, 2.3, t_to, observable=obs),
          tr.reweight(E, 2.3, t_to, observable=obs))


def test_reweight_errors_match_jax():
    E, M = RUNS[1]
    for args, kw in (((E, 2.3, 20.0), {}), ((np.array([]), 2.3, 2.4), {}),
                     ((E, 2.3, 2.4), {"observable": M[:-1]}),
                     ((E, 2.3, 2.4), {"min_ess": 1e9})):
        _errors_alike(lambda: jr.reweight(*args, **kw),
                      lambda: tr.reweight(*args, **kw))


def test_reweight_curve_matches_jax():
    E, M = RUNS[0]
    grid = np.linspace(1.5, 3.5, 13)
    _same(jr.reweight_curve(E, 2.0, grid), tr.reweight_curve(E, 2.0, grid))
    _same(jr.reweight_curve(E, 2.0, grid, observable=np.abs(M)),
          tr.reweight_curve(torch.from_numpy(E), 2.0,
                            torch.from_numpy(grid),
                            observable=np.abs(M)))
    for args, kw in (((np.array([]), 2.0, grid), {}),
                     ((E, 2.0, grid), {"observable": M[:3]}),
                     ((E, 2.0, grid),
                      {"observable": np.stack([M, M], axis=1)})):
        _errors_alike(lambda: jr.reweight_curve(*args, **kw),
                      lambda: tr.reweight_curve(*args, **kw))


def test_wham_matches_jax():
    ej, et = jr.wham(ENERGIES, TEMPS), tr.wham(
        [torch.from_numpy(e) for e in ENERGIES],
        torch.tensor(TEMPS, dtype=torch.float64))
    for name in ("energies", "log_denom", "temps", "free_energies",
                 "iterations", "residual"):
        _same(getattr(ej, name), getattr(et, name))
    for t in (2.0, 2.15, 2.5):
        _same(ej.log_weights(t), et.log_weights(t))
        _same(ej.ess(t), et.ess(t))
        _same(ej.expectation(t), et.expectation(t))
        pooled = np.concatenate(MAGS)
        _same(ej.expectation(t, observable=pooled),
              et.expectation(t, observable=torch.from_numpy(pooled)))
        _same(ej.energy_moments(t), et.energy_moments(t))
        _same(ej.specific_heat(t, N), et.specific_heat(t, N))
    f0 = ej.free_energies + 0.1
    warm_j = jr.wham(ENERGIES, TEMPS, f_init=f0)
    warm_t = tr.wham(ENERGIES, TEMPS, f_init=torch.from_numpy(f0))
    _same(warm_j.free_energies, warm_t.free_energies)
    _same(warm_j.iterations, warm_t.iterations)


def test_wham_errors_match_jax():
    ej, et = jr.wham(ENERGIES, TEMPS), tr.wham(ENERGIES, TEMPS)
    _errors_alike(lambda: ej.expectation(2.3, min_ess=1e6),
                  lambda: et.expectation(2.3, min_ess=1e6))
    _errors_alike(lambda: ej.energy_moments(50.0, min_ess=20.0),
                  lambda: et.energy_moments(50.0, min_ess=20.0))
    _errors_alike(lambda: ej.expectation(2.3, observable=MAGS[0]),
                  lambda: et.expectation(2.3, observable=MAGS[0]))
    for args, kw in (((ENERGIES, TEMPS[:2]), {}),
                     ((ENERGIES[:1], TEMPS[:1]), {}),
                     ((ENERGIES[:2] + [np.array([])], TEMPS), {}),
                     ((ENERGIES, TEMPS), {"f_init": [0.0]}),
                     ((ENERGIES, TEMPS), {"maxiter": 1, "tol": 1e-30})):
        _errors_alike(lambda: jr.wham(*args, **kw),
                      lambda: tr.wham(*args, **kw))


def test_wham_jackknife_matches_jax():
    stat = lambda ens: ens.specific_heat(2.3, N)    # noqa: E731
    _same(jr.wham_jackknife(ENERGIES, TEMPS, stat, nblocks=5),
          tr.wham_jackknife(ENERGIES, TEMPS, stat, nblocks=5))
    chi = lambda ens, m: (ens.expectation(2.3, observable=m * m)[0]  # noqa
                          - ens.expectation(2.3, observable=m)[0] ** 2)
    _same(jr.wham_jackknife(ENERGIES, TEMPS, chi, nblocks=4,
                            observables_by_run=MAGS),
          tr.wham_jackknife(ENERGIES, TEMPS, chi, nblocks=4,
                            observables_by_run=[torch.from_numpy(m)
                                                for m in MAGS]))
    for args, kw in (((ENERGIES, TEMPS, stat), {"nblocks": 1}),
                     ((ENERGIES, TEMPS, stat), {"nblocks": 300}),
                     ((ENERGIES, TEMPS, chi),
                      {"observables_by_run": MAGS[:2]})):
        _errors_alike(lambda: jr.wham_jackknife(*args, **kw),
                      lambda: tr.wham_jackknife(*args, **kw))


def test_peak_location_matches_jax():
    ens = tr.wham(ENERGIES, TEMPS)
    curve = lambda t: ens.specific_heat(t, N)   # noqa: E731
    for lo, hi, tol in ((2.0, 2.6, 1e-6), (2.1, 2.4, 1e-3)):
        _same(jr.peak_location(curve, lo, hi, tol=tol),
              tr.peak_location(curve, lo, hi, tol=tol))
    quad = lambda t: -(t - 0.3) ** 2   # noqa: E731
    _same(jr.peak_location(quad, 0.0, 1.0, maxiter=5),
          tr.peak_location(quad, 0.0, 1.0, maxiter=5))
    _errors_alike(lambda: jr.peak_location(quad, 1.0, 1.0),
                  lambda: tr.peak_location(quad, 1.0, 1.0))
