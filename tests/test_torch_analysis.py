"""The port's analysis module against the JAX package's, at tolerance 0:
every public function on the same inputs (made from a seed with numpy)
returns the same floats and raises the same ValueErrors. Torch tensors
are taken as inputs too. jackknife_binder_u4, the port's O(n) jackknife
of binder_u4, is held against jackknife(samples, binder_u4) at a
relative 1e-9 (the sums run in another order)."""

import math

import numpy as np
import pytest
import torch

from ising_tpu import analysis as ja
from ising_tpu_torch import analysis as ta


def _same(a, b):
    """Equal floats (nan equal to nan), tuples and dicts of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
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


def _ms(seed, shape):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape)


def _ar1(seed, n, phi=0.9):
    rng = np.random.default_rng(seed)
    x = np.empty(n)
    x[0] = rng.normal()
    for i in range(1, n):
        x[i] = phi * x[i - 1] + rng.normal()
    return x


def test_moment_accumulator_matches_jax():
    acc_j, acc_t = ja.MomentAccumulator(), ta.MomentAccumulator()
    for k in range(5):
        ms = _ms(k, 37)
        acc_j.add(ms)
        acc_t.add(torch.from_numpy(ms) if k % 2 else ms)
    for name in ("n", "s1", "s2", "s4", "mean", "m2", "m4"):
        _same(getattr(acc_j, name), getattr(acc_t, name))
    _same(acc_j.binder_cumulant(), acc_t.binder_cumulant())
    _same(acc_j.susceptibility(4096, 2.3), acc_t.susceptibility(4096, 2.3))
    _same(acc_j.specific_heat(4096, 2.3), acc_t.specific_heat(4096, 2.3))
    empty_j, empty_t = ja.MomentAccumulator(), ta.MomentAccumulator()
    _same(empty_j.binder_cumulant(), empty_t.binder_cumulant())
    _same(empty_j.mean, empty_t.mean)


@pytest.mark.parametrize("shape", [(64,), (32, 9), (0,), (5,)])
def test_binder_u4_and_g_match_jax(shape):
    s = _ms(1, shape) - 0.5
    _same(ja.binder_u4(s), ta.binder_u4(s))
    _same(ja.binder_u4(s), ta.binder_u4(torch.from_numpy(s)))
    _same(ja.binder_g(s), ta.binder_g(s))
    z = np.zeros(shape)
    _same(ja.binder_u4(z), ta.binder_u4(z))
    _same(ja.binder_g(z), ta.binder_g(z))


@pytest.mark.parametrize("n", [8, 100, 3000])
def test_autocorrelation_and_binned_error_match_jax(n):
    x = _ar1(n, n)
    _same(ja.autocorrelation_time(x), ta.autocorrelation_time(x))
    _same(ja.autocorrelation_time(x, c=3.0),
          ta.autocorrelation_time(torch.from_numpy(x), c=3.0))
    _same(ja.autocorrelation_time(np.ones(n)),
          ta.autocorrelation_time(np.ones(n)))
    for nbins in (2, 7, 32):
        _same(ja.binned_error(x, nbins), ta.binned_error(x, nbins))
    _errors_alike(lambda: ja.autocorrelation_time(x[:7]),
                  lambda: ta.autocorrelation_time(x[:7]))
    _errors_alike(lambda: ja.binned_error(x[:3]),
                  lambda: ta.binned_error(x[:3]))


def test_jackknife_matches_jax():
    s = _ms(3, (40, 6))
    _same(ja.jackknife(s, ja.binder_u4), ta.jackknife(s, ta.binder_u4))
    _same(ja.jackknife(s[:, 0], np.mean),
          ta.jackknife(torch.from_numpy(s[:, 0]), np.mean))
    _errors_alike(lambda: ja.jackknife(s[:1], np.mean),
                  lambda: ta.jackknife(s[:1], np.mean))


@pytest.mark.parametrize("shape", [(2, 1), (40, 6), (1024, 50), (300,)])
def test_jackknife_binder_u4_matches_jackknife(shape):
    """The O(n) jackknife of binder_u4 against the generic one, at a
    relative 1e-9; with a sample of zeros among them, and all zeros."""
    s = _ms(4, shape)
    s[0] = 0.0
    want = ta.jackknife(s, ta.binder_u4)
    got = ta.jackknife_binder_u4(s)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(
        ta.jackknife_binder_u4(torch.from_numpy(s)), got)
    z = np.zeros(shape)
    assert all(math.isnan(v) for v in ta.jackknife_binder_u4(z))
    assert all(math.isnan(v) for v in ta.jackknife(z, ta.binder_u4))
    with pytest.raises(ValueError, match="at least 2 samples"):
        ta.jackknife_binder_u4(s[:1])


@pytest.mark.parametrize("L", [8, 13, 64])
def test_fourier_and_xi_match_jax(L):
    rng = np.random.default_rng(L)
    counts = rng.integers(0, L + 1, L)
    _same(ja.kmin_mag2(counts, L), ta.kmin_mag2(counts, L))
    _same(ja.kmin_mag2(counts, L),
          ta.kmin_mag2(torch.from_numpy(counts), L))
    for m0, mk in ((5.0, 2.0), (1.0, 3.0), (4.0, 0.0), (4.0, -1.0)):
        _same(ja.second_moment_xi(m0, mk, L), ta.second_moment_xi(m0, mk, L))
    m0s = rng.uniform(10.0, 20.0, 30)
    mks = rng.uniform(1.0, 4.0, 30)
    _same(ja.correlation_length(m0s, mks, L),
          ta.correlation_length(m0s, torch.from_numpy(mks), L))
    spins = 2.0 * rng.integers(0, 2, (L, 2 * L)) - 1.0
    _same(ja.structure_factor(spins), ta.structure_factor(spins))
    _same(ja.structure_factor(spins),
          ta.structure_factor(torch.from_numpy(spins)))


def test_binder_crossing_matches_jax():
    t = np.linspace(2.0, 2.5, 9)
    a = 0.6 - 0.3 * np.tanh(3 * (t - 2.27))
    b = 0.6 - 0.3 * np.tanh(6 * (t - 2.27))
    for u4 in ({8: a, 16: b}, {8: a, 16: a + 1e-3}, {8: a, 4: b, 16: a},
               {8: a, 16: np.where(np.arange(9) == 4, a, b)}):
        _same(ja.binder_crossing(t, u4), ta.binder_crossing(t, u4))
    _same(ja.binder_crossing(t, {8: a, 16: b}),
          ta.binder_crossing(torch.from_numpy(t),
                             {8: torch.from_numpy(a), 16: b}))
    _errors_alike(lambda: ja.binder_crossing(t, {8: a}),
                  lambda: ta.binder_crossing(t, {8: a}))


def _synthetic(seed, zeta=0.0, sizes=(8, 16, 32), n=11, noise=0.01):
    """Curves of F(x) = .6 - .4 tanh x at (Tc, nu) = (2.269, 1) with
    Gaussian noise of known size."""
    rng = np.random.default_rng(seed)
    data = {}
    for L in sizes:
        temps = np.linspace(2.269 - 0.2, 2.269 + 0.2, n)
        y = L ** zeta * (0.6 - 0.4 * np.tanh((temps - 2.269) * L))
        dy = np.full_like(y, noise * max(1.0, L ** zeta))
        data[L] = (temps, y + rng.normal(0.0, dy), dy)
    return data


def test_collapse_quality_matches_jax():
    data = _synthetic(0)
    for tc, nu, zeta in ((2.269, 1.0, 0.0), (2.3, 1.4, 0.0),
                         (2.25, 0.8, 0.5)):
        _same(ja.collapse_quality(data, tc, nu, zeta),
              ta.collapse_quality(data, tc, nu, zeta))
    t, y, e = data[8]
    _errors_alike(lambda: ja.collapse_quality({8: data[8]}, 2.269, 1.0),
                  lambda: ta.collapse_quality({8: data[8]}, 2.269, 1.0))
    bad = {8: (t, y, e), 16: (t, y[:-1], e)}
    _errors_alike(lambda: ja.collapse_quality(bad, 2.269, 1.0),
                  lambda: ta.collapse_quality(bad, 2.269, 1.0))
    bad = {8: (t, y, e), 16: (t, y, np.zeros_like(e))}
    _errors_alike(lambda: ja.collapse_quality(bad, 2.269, 1.0),
                  lambda: ta.collapse_quality(bad, 2.269, 1.0))
    apart = {8: (t, y, e), 16: (t + 5.0, y, e)}
    _errors_alike(lambda: ja.collapse_quality(apart, 2.269, 1.0),
                  lambda: ta.collapse_quality(apart, 2.269, 1.0))


def test_fit_collapse_matches_jax():
    data = _synthetic(3, sizes=(8, 16), n=9)
    _same(ja.fit_collapse(data, tc0=2.24, nu0=1.2, errors=True),
          ta.fit_collapse(data, tc0=2.24, nu0=1.2, errors=True))
    _same(ja.fit_collapse(data, tc0=2.3, nu0=0.9),
          ta.fit_collapse(data, tc0=2.3, nu0=0.9))
    chi = _synthetic(5, zeta=1.75, sizes=(8, 16), n=9, noise=0.005)
    _same(ja.fit_collapse(chi, tc0=2.25, nu0=1.1, zeta0=1.6),
          ta.fit_collapse(chi, tc0=2.25, nu0=1.1, zeta0=1.6))


def test_binder_g_disorder_matches_jax():
    rng = np.random.default_rng(7)
    q2 = rng.uniform(0.2, 0.5, 12)
    q4 = q2 ** 2 * rng.uniform(1.0, 2.0, 12)
    _same(ja.binder_g_disorder(q2, q4),
          ta.binder_g_disorder(torch.from_numpy(q2), q4))
    _errors_alike(lambda: ja.binder_g_disorder(q2, q4[:-1]),
                  lambda: ta.binder_g_disorder(q2, q4[:-1]))
