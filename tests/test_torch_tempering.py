"""Parallel tempering in the port (ising_tpu_torch/tempering.py, the CLI's
--pt) against the JAX package's, exactly.

The scalar swap stream against the naive Philox reference and the JAX
package's; the swap thresholds and the ladder feedback; then whole runs:
each rung's final words, the Hamiltonians, accepts, attempts,
replica_at, round trips, measure() and collect_energies() of the port's
ParallelTempering, batched and per rung, against the JAX package's with
the same config and backend (xla, also with -J 0.4 and on a ladder of
equal temperatures whose replicas make round trips; bit1 at 64 columns,
also in threefry13b across a retemper; packed), at 16 x 64 with 4 rungs
and 5 rounds, the JAX Pallas backends in interpret mode. Last, the CLI's
--pt lines against the JAX CLI's with the same flags. Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import tempering as jt
from ising_tpu_torch import SimConfig, cli, tempering
from ising_tpu_torch.tempering import ParallelTempering
from naive_reference import philox4x32_ref

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("rounds", [10, 7])
def test_philox4x32_scalar_matches_reference(rounds):
    gen = np.random.default_rng(rounds)
    cases = [((0, 0, 0, 0), (0, 0)), ((M32,) * 4, (M32,) * 2)] + [
        (tuple(int(x) for x in gen.integers(0, 1 << 32, 4)),
         tuple(int(x) for x in gen.integers(0, 1 << 32, 2)))
        for _ in range(16)]
    for ctr, key in cases:
        got = tempering.philox4x32_scalar(ctr, key, rounds)
        assert got == jt.philox4x32_scalar(ctr, key, rounds)
        if rounds == 10:
            assert list(got) == list(philox4x32_ref(ctr, key)), (ctr, key)


def test_swap_threshold_u32_endpoints_and_jax():
    f = tempering.swap_threshold_u32
    assert f(0.0, 12345) == f(0.5, 100) == f(-0.5, -100) == 1 << 32
    assert f(-0.25, 8) == int(np.exp(-2.0) * (1 << 32)) < 1 << 32
    assert f(-2.0, 10 ** 4) == 0
    gen = np.random.default_rng(3)
    for dbeta, de in zip(gen.normal(0, 0.3, 64), gen.integers(-300, 300, 64)):
        assert f(float(dbeta), int(de)) == jt.swap_threshold_u32(
            float(dbeta), int(de))


@pytest.mark.parametrize("temps,acc", [
    ([1.0, 1.5, 2.0, 3.0], [0.9, 0.2, 0.5]),
    ([0.8, 1.0, 1.3, 1.7, 2.2], [0.0, 1.0, 0.3, 0.995]),
])
def test_equalize_ladder_matches_jax(temps, acc):
    got = tempering.equalize_ladder(temps, acc)
    assert got == jt.equalize_ladder(temps, acc)
    assert got[0] == temps[0] and got[-1] == temps[-1]
    with pytest.raises(ValueError, match="one acceptance rate"):
        tempering.equalize_ladder(temps, acc[:-1])


TEMPS = (1.9, 2.0, 2.1, 2.2)
ROUNDS = 5
# (name, config keywords, ladder, rounds before a retemper or None)
CASES = {
    "xla": (dict(backend="xla"), TEMPS, None),
    "xla J": (dict(backend="xla", j_prob=0.4), TEMPS, None),
    "xla equal": (dict(backend="xla", seed=7), (2.0, 2.0, 2.0), None),
    "bit1": (dict(backend="bit1"), TEMPS, None),
    "bit1 threefry13b retemper": (dict(backend="bit1", rng="threefry13b"),
                                  (1.6, 1.9, 2.2, 2.6), 2),
    "packed": (dict(backend="packed"), TEMPS, None),
}


def _run(PT, Config, case, batched, extra):
    """A ladder of one package, ROUNDS rounds (with a retemper onto the
    ladder equalize_ladder gives, where the case has one), then its record
    and collect_energies(2)."""
    kw, temps, retemper_at = CASES[case]
    kw = {**dict(nrows=16, ncols=64, temp=1.0, seed=99), **kw, **extra}
    pt = PT(Config(**kw), list(temps), sweeps_per_swap=2, batched=batched)
    for r in range(ROUNDS):
        if r == retemper_at:
            mod = tempering if PT is ParallelTempering else jt
            pt.retemper(mod.equalize_ladder(pt.temps,
                                            pt.stats()["pair_acceptance"]))
        pt.advance_round()
    bits = [tuple(np.asarray(p.numpy() if isinstance(p, torch.Tensor)
                             else p) for p in s.bits()) for s in pt.sims]
    rec = {"stats": pt.stats(), "accepts": pt.accepts,
           "attempts": pt.attempts, "temps": pt.temps,
           "measure": pt.measure(), "steps": [s.step for s in pt.sims]}
    energies = pt.collect_energies(2)
    rec["collect"] = [e.tolist() for e in energies]
    rec["measure after"] = pt.measure()
    return bits, rec


@functools.lru_cache(maxsize=None)
def _jax(case):
    return _run(jt.ParallelTempering, JaxConfig, case, True, {})


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_pt_run_matches_jax(case, batched):
    want_bits, want = _jax(case)
    bits, got = _run(ParallelTempering, SimConfig, case, batched,
                     {"device": "cpu"})
    assert got == want
    for rung, (a, b) in enumerate(zip(bits, want_bits)):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q, err_msg=f"rung {rung}")
    assert sum(want["accepts"]) > 0
    if case == "xla equal":
        assert sum(want["stats"]["round_trips"]) > 0
    if CASES[case][2] is not None:
        assert want["temps"] != list(CASES[case][1])


def test_retemper_steps_with_the_new_thresholds():
    """bit1's k-bit thresholds follow retemper: a ladder retempered onto
    another equals one built there, from the same states and round."""
    kw = dict(nrows=16, ncols=64, temp=1.0, seed=5, backend="bit1",
              rng="threefry13b", device="cpu")
    a = ParallelTempering(SimConfig(**kw), [1.0, 1.1], sweeps_per_swap=2)
    b = ParallelTempering(SimConfig(**kw), [2.4, 2.5], sweeps_per_swap=2)
    a.retemper([2.4, 2.5])
    assert [s.backend.accept for s in a.sims] == \
        [s.backend.accept for s in b.sims]
    for pt in (a, b):
        for _ in range(3):
            pt.advance_round()
    assert a.measure() == b.measure() and a.replica_at == b.replica_at


def test_giant_rung_fallback_matches_inline():
    """Above the _inline_obs cap the partials are taken in row chunks: the
    same records."""
    runs = []
    for inline in (True, False):
        pt = ParallelTempering(SimConfig(nrows=16, ncols=64, temp=1.0,
                                         seed=99, backend="packed",
                                         device="cpu"),
                               list(TEMPS), sweeps_per_swap=2)
        assert pt._inline_obs
        pt._inline_obs = inline
        for _ in range(4):
            pt.advance_round()
        runs.append((pt.accepts, pt.replica_at, pt.measure()))
    assert runs[0] == runs[1]


def test_measure_cache_tracks_swaps():
    pt = ParallelTempering(SimConfig(nrows=16, ncols=32, temp=1.0, seed=99,
                                     device="cpu"),
                           [1.5, 1.7, 1.9], sweeps_per_swap=1)
    for _ in range(3):
        pt.advance_round()
    cached = pt.measure()
    assert pt._cache is not None
    pt._cache = None
    assert pt.measure() == cached


def test_one_transfer_a_round(monkeypatch):
    """A batched round brings its per-rung totals back with one .cpu()."""
    calls = []
    orig = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (calls.append(1),
                                               orig(self, *a, **k))[1])
    pt = ParallelTempering(SimConfig(nrows=16, ncols=64, temp=1.0,
                                     backend="bit1", device="cpu"),
                           list(TEMPS), sweeps_per_swap=1)
    calls.clear()
    pt.advance_round()
    pt.measure()
    assert len(calls) == 1


@pytest.mark.parametrize("bad,match", [
    (dict(temps=[1.5]), "at least 2"),
    (dict(temps=[0.0, 1.5]), "> 0"),
    (dict(replica_seeds=[1]), "one replica seed"),
    (dict(sweeps_per_swap=0), "sweeps_per_swap"),
    (dict(field=0.1), "field == 0"),
])
def test_validation_matches_jax(bad, match):
    bad = dict(bad)
    temps = bad.pop("temps", [1.0, 2.0])
    field = bad.pop("field", 0.0)
    errors = []
    for PT, Config, kw in ((jt.ParallelTempering, JaxConfig, {}),
                           (ParallelTempering, SimConfig,
                            {"device": "cpu"})):
        cfg = Config(nrows=16, ncols=32, temp=1.0, field=field, **kw)
        with pytest.raises(ValueError, match=match) as e:
            PT(cfg, temps, **bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_retemper_errors():
    pt = ParallelTempering(SimConfig(nrows=16, ncols=32, temp=1.0,
                                     device="cpu"), [1.0, 2.0])
    with pytest.raises(ValueError, match="ladder size"):
        pt.retemper([1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="> 0"):
        pt.retemper([0.0, 2.0])


def _pt_lines(text):
    return [ln for ln in text.splitlines()
            if "T = " in ln or ln.startswith(("Pair acceptance",
                                              "Completed round trips"))]


@pytest.mark.parametrize("backend", ["xla", "bit1", "packed"])
def test_cli_pt_lines_match_jax(backend, capsys):
    argv = ["--backend", backend, "-x", "64", "-y", "16", "-J", "0.4",
            "--pt", "1.9,2.0,2.1", "-n", "4", "-p", "2",
            "--sweeps-per-swap", "2", "-s", "99"]
    assert jcli.main(argv) == 0
    want = _pt_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ising-tpu-torch parallel tempering:")
    assert "\tdevice: cpu" in out
    assert _pt_lines(out) == want and len(want) == 8
    assert want[-1].startswith("Completed round trips: ")


def test_cli_pt_refusals(capsys):
    """A ladder the library refuses exits 1 with its message, as in the
    JAX CLI; --devs 2 runs every rung over two row slabs, with the JAX
    CLI's lines."""
    base = ["-x", "64", "-y", "16", "-n", "1", "--device", "cpu"]
    assert cli.main(base + ["--pt", "1.0"]) == 1
    assert "ERROR: parallel tempering needs at least 2 rungs" in \
        capsys.readouterr().err
    assert cli.main(base + ["--pt", "1.0,2.0", "--field", "0.1"]) == 1
    assert "field == 0" in capsys.readouterr().err
    argv = base[:-2] + ["--pt", "1.0,2.0", "--devs", "2", "-J", "0.3"]
    assert jcli.main(argv) == 0
    want = _pt_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "not yet ported" not in err
    assert _pt_lines(out) == want and len(want) == 4
