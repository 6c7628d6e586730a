"""The port's xla backend, and the driver's field and ramp paths, against
the JAX package.

ising_tpu_torch/ops/xla_ref.py is held against ising_tpu/ops/xla_ref.py
(one half-sweep in every counter mode, with and without a field, and in
the greedy quench), and Simulation trajectories of both port backends
against the JAX package's in every mode each runs (hw on bit1, against
the JAX bit1 kernel in interpret mode), a temperature ramp in a
bit-plane mode, set_field, and the field's observables. Every compared value is an integer or a bit pattern, so the
tolerance is exact equality; the one exception is xla in hw mode, whose
draws come from torch's generator here and from jax.random there, so it
is held to the same physics statistically.
"""

import zlib

import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import xla_ref as jxla
from ising_tpu_torch import SimConfig, cli, interop, observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import xla_ref
from ising_tpu_torch.ops.bit1 import pack_bits1
from ising_tpu_torch.rng import PORTED_MODES, plane_bits

COUNTER_MODES = [m for m in PORTED_MODES if m != "hw"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once, and torch's intra-op threads
    on top of them slowed this file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(gen, shape):
    return gen.integers(0, 2, shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode", COUNTER_MODES)
@pytest.mark.parametrize("temp,field", [(1.8, 0.0), (0.0, 0.0), (1.3, 0.4)])
def test_update_color_matches_jax(mode, temp, field):
    H, C = 8, 64
    gen = np.random.default_rng(zlib.crc32(f"{mode} {temp} {field}".encode()))
    dst, src = _bits(gen, (H, C)), _bits(gen, (H, C))
    thr = ising.threshold_table(temp, field)
    kw = dict(nrows=H, ncols=2 * C, temp=temp, field=field, rng=mode,
              seed=int(gen.integers(0, 1 << 62)), backend="xla")
    jbe = jxla.XlaBackend(JaxConfig(**kw))
    tbe = xla_ref.XlaBackend(SimConfig(device="cpu", **kw))
    step, row0 = int(gen.integers(0, 1 << 32)), (1 << 29) - 4
    for color in (0, 1):
        want = jbe.update_color(dst, src, color=color, thr10=thr, step=step,
                                row0=row0, src_up=src[-1:], src_dn=src[:1])
        got = tbe.update_color(_t(dst), _t(src), color=color, thr10=thr,
                               step=step, row0=row0, src_up=_t(src[-1:]),
                               src_dn=_t(src[:1]))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_threshold_matches_jax():
    gen = np.random.default_rng(4)
    b = _bits(gen, (4, 50))
    n = gen.integers(0, 5, (4, 50)).astype(np.uint8)
    for temp, field in ((1.5, 0.0), (0.0, 0.0), (2.0, -0.6)):
        thr = ising.threshold_table(temp, field)
        for tf, jf in ((xla_ref.select_threshold, jxla.select_threshold),
                       (xla_ref.select_threshold_full,
                        jxla.select_threshold_full)):
            if tf is xla_ref.select_threshold and field:
                continue
            np.testing.assert_array_equal(
                tf(_t(b), _t(n), thr).numpy(),
                np.asarray(jf(b, n, thr)).astype(np.int64))


def test_neighbor_bit_sum_matches_jax():
    gen = np.random.default_rng(5)
    src = _bits(gen, (6, 10))
    for color in (0, 1):
        np.testing.assert_array_equal(
            xla_ref.neighbor_bit_sum(_t(src), color=color, H=6,
                                     src_up=_t(src[-1:]),
                                     src_dn=_t(src[:1])).numpy(),
            np.asarray(jxla.neighbor_bit_sum(src, color=color, H=6,
                                             src_up=src[-1:],
                                             src_dn=src[:1])))


def test_plane_observables_match_jax():
    gen = np.random.default_rng(6)
    for Y, C in ((4, 8), (6, 32), (10, 64)):
        b, w = _bits(gen, (Y, C)), _bits(gen, (Y, C))
        np.testing.assert_array_equal(
            observables.row_up_counts(_t(b), _t(w)).numpy(),
            np.asarray(jobs.row_up_counts(b, w)))
        for chunk in (8192, 2):
            np.testing.assert_array_equal(
                observables.energy_row_sums(_t(b), _t(w),
                                            row_chunk=chunk).numpy(),
                np.asarray(jobs.energy_row_sums(b, w)))


def _logs(sim):
    lines = []
    sim.run(log=lines.append)
    return lines


def _states(sim):
    return [np.asarray(x) for x in sim.bits()]


def _same_run(jcfg, tcfgs):
    """Run the JAX package's Simulation and the port's for each config;
    the log lines (bar the timing line), the measurements, the energy and
    the final lattices must be equal. Returns the port's simulations."""
    jsim = JaxSimulation(jcfg)
    want = _logs(jsim)
    sims = []
    for tcfg in tcfgs:
        tsim = Simulation(tcfg)
        got = _logs(tsim)
        assert got[:-1] == want[:-1]
        assert got[-1].startswith("Kernel execution time")
        assert tsim.measure() == jsim.measure()
        assert tsim.energy() == jsim.energy()
        for x, y in zip(_states(jsim), _states(tsim)):
            np.testing.assert_array_equal(x, y)
        sims.append(tsim)
    return sims


def _jax_backend(mode):
    """The JAX package's backend to hold the port to: xla, or its bit1
    kernel in interpret mode for the bit-plane modes (whose xla path takes
    up to a minute to compile on the CPU; the JAX package holds its two
    backends equal there) and for hw (whose xla path draws from
    jax.random)."""
    return "bit1" if mode == "hw" or plane_bits(mode) else "xla"


# (mode, temperature, field): every mode, T > 0 and the greedy quench
# alternating, the bit-plane modes and hw with a field too, and a u32 mode
# with a field on xla's full table. Each case runs both port backends where
# the mode allows: bit1 takes a field only in the bit-plane modes and hw,
# and xla's hw draws from torch's generator.
_TEMP = {m: (1.6, 0.0)[i % 2] for i, m in enumerate(PORTED_MODES)}
TRAJ = ([(m, t, 0.0) for m, t in _TEMP.items()]
        + [(m, 1.6 - _TEMP[m], (0.15, -0.3)[i % 2]) for i, m in
           enumerate(m for m in PORTED_MODES if plane_bits(m) or m == "hw")]
        + [("chacha8", 1.4, 0.2)])


def _port_backends(mode, field):
    return [be for be in ("xla", "bit1")
            if not (be == "xla" and mode == "hw")
            and not (be == "bit1" and field and not plane_bits(mode)
                     and mode != "hw")]


@pytest.mark.parametrize("mode,temp,field", TRAJ)
def test_simulation_matches_jax(mode, temp, field):
    kw = dict(nrows=8, ncols=128, temp=temp, field=field, seed=31, rng=mode,
              niters=4, print_freq=2)
    _same_run(JaxConfig(backend=_jax_backend(mode), **kw),
              [SimConfig(backend=be, device="cpu", **kw)
               for be in _port_backends(mode, field)])


def test_trajectory_cases_cover_modes():
    xla = {c[0] for c in TRAJ if "xla" in _port_backends(c[0], c[2])}
    bit1 = {c[0] for c in TRAJ if "bit1" in _port_backends(c[0], c[2])}
    assert xla == set(PORTED_MODES) - {"hw"}
    assert bit1 == set(PORTED_MODES)
    assert {c[0] for c in TRAJ if c[2]} == \
        {m for m in PORTED_MODES if plane_bits(m)} | {"hw", "chacha8"}
    for mode in PORTED_MODES:
        if plane_bits(mode) or mode == "hw":
            assert {c[1] <= 0 for c in TRAJ if c[0] == mode} == {True, False}
    assert {c[1] <= 0 for c in TRAJ if not plane_bits(c[0])} == {True, False}


@pytest.mark.parametrize("backend", ["bit1", "xla"])
def test_temperature_ramp_in_plane_mode(backend):
    """-u in a bit-plane mode: the k-bit thresholds follow the ramp, as in
    the JAX package (and unlike a backend that kept its first ones)."""
    kw = dict(nrows=8, ncols=128, temp=0.9, seed=41, rng="chacha6b",
              niters=12, print_freq=3, temp_step=1.1, temp_freq=4)
    tsim, = _same_run(JaxConfig(backend="bit1", **kw),
                      [SimConfig(backend=backend, device="cpu", **kw)])
    assert tsim.backend.temperature == pytest.approx(0.9 + 3 * 1.1)
    assert tsim.temp == tsim.backend.temperature
    # A backend left at the first temperature draws another trajectory.
    stale = Simulation(SimConfig(backend=backend, device="cpu", **kw))
    stale.set_temperature = lambda t: setattr(stale, "temp", t)
    stale.run(log=lambda line: None)
    assert any(not np.array_equal(x, y)
               for x, y in zip(_states(stale), _states(tsim)))


@pytest.mark.parametrize("backend,mode", [("bit1", "chacha8b"),
                                          ("xla", "threefry13"),
                                          ("xla", "philox7b"),
                                          ("bit1", "hw")])
def test_set_field_matches_fresh_simulation(backend, mode):
    """set_field(h) then n steps equals a Simulation built with field h
    from the same start; and h back to 0 equals a field-free one."""
    kw = dict(nrows=8, ncols=128, temp=1.4, seed=51, rng=mode,
              backend=backend, device="cpu")
    for h0, h1 in ((0.0, 0.35), (0.35, 0.0), (0.2, -0.5)):
        if backend == "bit1" and mode != "hw" and not plane_bits(mode):
            continue
        sim = Simulation(SimConfig(field=h0, **kw))
        sim.set_field(h1)
        assert sim.cfg.field == h1 and sim.backend.field == h1
        if backend == "xla":
            assert sim.backend.full_table == (h1 != 0.0)
        fresh = Simulation(SimConfig(field=h1, **kw))
        sim.advance(3)
        fresh.advance(3)
        for x, y in zip(_states(sim), _states(fresh)):
            np.testing.assert_array_equal(x, y)
        assert sim.measure() == fresh.measure()
        assert sim.energy() == fresh.energy()


def test_set_field_matches_jax_and_validates():
    kw = dict(nrows=8, ncols=128, temp=1.4, seed=52, rng="chacha4b")
    jsim = JaxSimulation(JaxConfig(backend="bit1", **kw))
    tsim = Simulation(SimConfig(backend="bit1", device="cpu", **kw))
    for h in (0.5, 0.0, -0.25):
        jsim.set_field(h)
        tsim.set_field(h)
        jsim.advance(2)
        tsim.advance(2)
        assert tsim.measure() == jsim.measure()
        assert tsim.energy() == jsim.energy()
    assert "m_signed" in tsim.measure()
    u32 = Simulation(SimConfig(backend="bit1", device="cpu",
                               **dict(kw, rng="philox")))
    with pytest.raises(ValueError, match="bit-serial accept"):
        u32.set_field(0.1)


def test_field_observables():
    kw = dict(nrows=8, ncols=128, temp=2.0, seed=53, rng="threefry13b",
              field=0.6, backend="bit1", device="cpu")
    sim = Simulation(SimConfig(**kw))
    sim.advance(4)
    m = sim.measure()
    assert m["m_signed"] == (m["up"] - m["down"]) / (m["up"] + m["down"])
    bonds = sim.energy_total()
    assert sim.energy() == (-bonds - 0.6 * (m["up"] - m["down"])) / 1024
    # The field pulls the magnetization up.
    assert m["m_signed"] > 0.3


def test_xla_hw_matches_philox_statistically():
    """xla in hw mode draws from torch's generator; jax.random's stream
    cannot be reproduced, so it is held to the physics instead: at
    T = 3.0 (above T_c, short correlation times) the mean energy per
    spin over 150 sweeps of a 32 x 32 lattice must agree with a philox
    run's and with Onsager's value. The tolerance, 0.04, is over four
    standard errors of the difference of the two means."""
    def mean_energy(rng):
        sim = Simulation(SimConfig(nrows=32, ncols=32, temp=3.0, seed=61,
                                   rng=rng, backend="xla", device="cpu"))
        sim.advance(50)
        es = []
        for _ in range(150):
            sim.advance(1)
            es.append(sim.energy())
        return float(np.mean(es))

    e_hw, e_ph = mean_energy("hw"), mean_energy("philox")
    assert abs(e_hw - e_ph) < 0.04
    assert abs(e_hw - ising.onsager_energy(3.0)) < 0.04


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("extra", [[], ["--rng", "chacha6"],
                                   ["--rng", "chacha8", "--field", "0.3"]])
def test_cli_default_backend_prints_jax_lines(extra, capsys):
    """No --backend: the xla backend, with the JAX CLI's lines."""
    argv = ["-x", "256", "-y", "16", "-n", "8", "-p", "4", "-t", "1.7", "-s",
            "78"] + extra
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "backend: xla" in got
    assert len(_mag_lines(want)) == 4 and _mag_lines(got) == _mag_lines(want)
    assert ("external field: h = 0.3" in got) == bool(extra[2:])


def test_xla_backend_holds_bit_planes():
    sim = Simulation(SimConfig(nrows=8, ncols=64, device="cpu"))
    assert sim.backend.name == "xla" and sim.backend.bytes_per_spin == 1.0
    assert sim.black.dtype == torch.uint8 and sim.black.shape == (8, 32)
    bit1 = Simulation(SimConfig(nrows=8, ncols=64, backend="bit1",
                                device="cpu"))
    for x, y in zip(interop.to_numpy_words(*map(pack_bits1, sim.bits())),
                    interop.to_numpy_words(bit1.black, bit1.white)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="ncols % 64"):
        Simulation(SimConfig(nrows=8, ncols=32, rng="chacha8b",
                             device="cpu"))
