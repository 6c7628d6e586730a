"""The port's spans and counters (utils/profiling.py): off, a span is one
shared null context that enters no profiler range, records no CUDA event
and keeps nothing; on (under a torch profiler, or after enable()), the
step loop, the halo rows, the measurement, the decode and the tile sums
record nested spans with their launches, bytes and device events, and
the set-up spans are recorded either way. This file imports no JAX, so
that its card tests run where JAX is absent (pytest --noconftest -m gpu).
"""

import pytest
import torch

from ising_tpu_torch import SimConfig, observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.ops import bit1, kernel_lib
from ising_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.enable(False)
    profiling.clear()
    yield
    profiling.enable(False)
    profiling.clear()


def _sim(device="cpu", **kw):
    args = dict(nrows=16, ncols=64, temp=1.5, backend="bit1", device=device)
    args.update(kw)
    return Simulation(SimConfig(**args))


def _named(name):
    return [s for s in profiling.spans() if s.name == name]


def _tracing():
    return (profiling._enabled
            or torch.autograd.profiler._is_profiler_enabled)


def _refuse(*args, **kwargs):
    raise AssertionError("entered while tracing is off")


def test_off_enters_no_range_records_no_event_keeps_nothing(monkeypatch):
    sim = _sim()
    profiling.clear()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert not _tracing()
    n0 = bit1.bit1_sweep.launches
    sim.advance(2)
    sim.measure()
    assert bit1.bit1_sweep.launches == n0
    assert profiling.spans() == [] and profiling.totals() == {}
    off = profiling.span("advance", torch.device("cuda", 0), launches=1)
    assert off is profiling.span("measure")
    with off as s:
        assert s is None
    assert profiling.spans() == []


def test_spans_nest_under_a_cpu_profiler():
    sim = _sim()
    profiling.clear()
    n0 = bit1.bit1_sweep.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.advance(3)
        sim.measure()
    advance, = _named("advance")
    launches = _named("launch")
    assert len(launches) == 6
    assert all(s.parent is advance and s.counts["kernel"] == "bit1_sweep"
               and s.device == torch.device("cpu") for s in launches)
    # A CPU tensor runs the plain version: no launch, and the span says so.
    assert advance.counts["launches"] == bit1.bit1_sweep.launches - n0 == 0
    children = sum(s.t1_ns - s.t0_ns for s in launches)
    assert advance.child_ns == children
    assert advance.self_s == pytest.approx(advance.host_s - children * 1e-9)
    measure, = _named("measure")
    assert [s.name for s in profiling.spans() if s.parent is measure] == [
        "count", "gather", "wait"]
    assert measure.parent is None and advance.parent is None
    names = {e.name for e in prof.events()}
    assert {"ising.advance", "ising.launch", "ising.measure", "ising.count",
            "ising.gather", "ising.wait"} <= names
    adv = next(e.time_range for e in prof.events()
               if e.name == "ising.advance")
    inner = [e.time_range for e in prof.events() if e.name == "ising.launch"]
    assert len(inner) == 6
    assert all(adv.start <= r.start and r.end <= adv.end for r in inner)


def test_launch_spans_count_the_wrappers_launches():
    """A wrapper that launches (here a stand-in that bumps its counter as
    the kernels' wrappers do on the card): its launch spans carry the
    launches, and the enclosing span adds them up."""

    def fake_kernel(x, *, times=1):
        with profiling.launch(fake_kernel, x):
            fake_kernel.launches += times
            return x

    fake_kernel.launches = 0
    x = torch.zeros(4)
    fake_kernel(x)
    assert fake_kernel.launches == 1 and profiling.spans() == []
    profiling.enable()
    with profiling.span("advance") as adv:
        fake_kernel(x)
        fake_kernel(x, times=2)
    assert [s.counts for s in _named("launch")] == [
        {"kernel": "fake_kernel", "launches": 1},
        {"kernel": "fake_kernel", "launches": 2}]
    assert adv.counts == {"launches": 3} and fake_kernel.launches == 4
    t = profiling.totals()
    assert t["launch"]["n"] == 2 and t["launch"]["launches"] == 3
    assert t["advance"]["launches"] == 3


def test_two_cpu_slabs_count_a_slab_and_copy_no_halo_bytes():
    sim = _sim(nrows=32, ndev=2)
    profiling.clear()
    profiling.enable()
    sim.advance(2)
    sim.measure()
    halo = _named("halo")
    advance, = _named("advance")
    assert len(halo) == 4      # two color phases a step
    assert all(s.parent is advance and s.counts["bytes"] == 0 for s in halo)
    assert advance.counts["bytes"] == 0
    measure, = _named("measure")
    counts = [s for s in _named("count") if s.parent is measure]
    assert len(counts) == 2
    assert len([s for s in _named("gather") if s.parent is measure]) == 3
    assert len([s for s in _named("wait") if s.parent is measure]) == 1


def test_setup_spans_are_recorded_with_tracing_off():
    assert not _tracing()
    _sim(nrows=32, ndev=2)
    names = [s.name for s in profiling.spans()]
    assert names.count("setup.lattice") == 2 and "setup.stepper" in names
    assert all(s.host_s >= 0 for s in profiling.spans())
    assert set(profiling.totals()) == {"setup.lattice", "setup.stepper"}


@pytest.mark.parametrize("cached", [True, False])
def test_the_kernels_load_is_a_setup_span(cached, monkeypatch):
    """kernel_lib.load's first call in a process records setup.kernels
    (a build, or the load of a cached one) with tracing off; later calls
    record nothing. A stand-in library (the C library, no entry points)
    takes the place of the nvcc build here."""
    import ctypes.util
    lib = ctypes.util.find_library("c")
    monkeypatch.setattr(kernel_lib, "_loaded", None)
    monkeypatch.setattr(kernel_lib, "SIGNATURES", {})
    monkeypatch.setattr(kernel_lib, "build", lambda: kernel_lib.BuildInfo(
        lib, 0.0 if cached else 1.0, cached, []))
    kernel_lib.load()
    kernel_lib.load()
    s, = profiling.spans()
    assert s.name == "setup.kernels" and s.counts == {"built": not cached}
    assert s.parent is None and s.host_s >= 0


def test_decode_and_tile_sums_of_the_replicas():
    sim = _sim(nrows=64, ncols=256, xsl=8, ysl=8)
    profiling.enable()
    sim.replica_magnetizations()
    decode, = _named("decode")
    tiles, = _named("tile_sums")
    assert decode.device == tiles.device == torch.device("cpu")
    assert decode.device_s is None and tiles.device_s is None
    unpack, = [s for s in _named("launch") if s.parent is decode]
    assert unpack.counts == {"kernel": "bit1_decode", "launches": 0}


def test_the_record_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    profiling.enable()
    for _ in range(8):
        with profiling.span("wait"):
            pass
    assert len(profiling.spans()) == 5
    assert profiling.totals()["wait"]["n"] == 8
    profiling.clear()
    assert profiling.spans() == [] and profiling.totals() == {}


def test_a_span_keeps_its_record_when_its_work_raises():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("measure"):
            with profiling.span("wait"):
                raise ValueError("x")
    wait, measure = profiling.spans()
    assert wait.parent is measure and measure.parent is None
    with profiling.span("advance") as s:
        assert s.parent is None


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pytest --noconftest -m gpu on the "
                    "card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_device_events_and_launches_on_the_card():
    dev = _cuda()
    kernel_lib.load()
    sim = _sim(device="cuda", nrows=64, ncols=256, xsl=8, ysl=8)
    profiling.clear()
    n0 = bit1.bit1_sweep.launches
    profiling.enable()
    sim.advance(4)
    sim.measure()
    ups = observables.replica_up_counts(*sim.bits(), 8, 8)
    torch.cuda.synchronize(dev)
    advance, = _named("advance")
    assert advance.counts["launches"] == bit1.bit1_sweep.launches - n0 == 8
    sweeps = [s for s in _named("launch") if s.parent is advance]
    assert len(sweeps) == 8
    assert all(s.counts == {"kernel": "bit1_sweep", "launches": 1}
               and s.device == dev and s.events is None for s in sweeps)
    for name in ("count", "decode", "tile_sums"):
        s, = _named(name)
        assert s.device == dev and s.device_s > 0, name
    decode, = _named("decode")
    unpack, = [s for s in _named("launch") if s.parent is decode]
    assert unpack.counts == {"kernel": "bit1_decode", "launches": 1}
    assert decode.counts == {"launches": 1}
    assert _named("wait")[0].device_s is None
    assert int(ups.sum()) == sim.measure()["up"]


@pytest.mark.gpu
def test_kernels_setup_span_on_the_card(monkeypatch):
    _cuda()
    kernel_lib.load()
    monkeypatch.setattr(kernel_lib, "_loaded", None)
    kernel_lib.load()
    s, = _named("setup.kernels")
    assert s.counts == {"built": False} and s.host_s > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [1, 4])
def test_halo_bytes_between_cards(cards):
    _cuda()
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    mesh = [torch.device("cuda", k % cards) for k in range(4)]
    sim = Simulation(SimConfig(nrows=256, ncols=512, temp=1.5,
                               backend="bit1", ndev=4, device="cuda"),
                     mesh=mesh)
    lattice = [s for s in profiling.spans() if s.name == "setup.lattice"]
    assert [s.device for s in lattice] == mesh
    assert all(s.counts["peak_bytes"] > 0 for s in lattice)
    profiling.clear()
    profiling.enable()
    sim.advance(3)
    sim.measure()
    sim.block()
    w1 = 512 // 64
    advance, = _named("advance")
    # 16 rows of W1 words of 4 B a step: two phases, four slabs, two rows.
    want = 16 * w1 * 4 * 3 if cards == 4 else 0
    assert advance.counts["bytes"] == want
    assert sum(s.counts["bytes"] for s in _named("halo")) == want
    counts = _named("count")
    assert [s.device for s in counts] == mesh
    assert all(s.device_s > 0 for s in counts)
