"""The readers of the program's own spans (metrics/launch_self_us.py,
step_loop_us, count_ms, measure_wait_ms, decode_ms, tile_sum_ms, init_s)
on a planted record: each metric's arithmetic, and None where the record
lacks the spans or the program keeps none (as an older program does)."""

from types import SimpleNamespace

import pytest

from ising_tpu_torch.utils import profiling
from isingbench.harness import ROOT, load

READERS = ("launch_self_us", "step_loop_us", "count_ms", "measure_wait_ms",
           "decode_ms", "tile_sum_ms", "init_s")


def sp(name, host_s=0.0, device_s=None, parent=None, **counts):
    return SimpleNamespace(name=name, host_s=host_s, device_s=device_s,
                           parent=parent, counts=counts)


def planted():
    """Two advances of 2 launches each, two measurements over two slabs,
    two samples, and the set-up (the kernels' load inside the stepper's
    span does not count twice)."""
    out = []
    for host in (100e-6, 140e-6):
        adv = sp("advance", host, launches=2)
        out += [sp("launch", 30e-6, parent=adv, kernel="bit1_sweep",
                   launches=1),
                sp("launch", 20e-6, parent=adv, kernel="bit1_sweep",
                   launches=1),
                sp("halo", 10e-6, parent=adv, bytes=0), adv]
    for waited in (2e-3, 4e-3):
        m = sp("measure", 20e-3)
        out += [sp("count", 1e-4, 12e-3, m), sp("count", 1e-4, 14e-3, m),
                sp("gather", 1e-4, None, m), sp("wait", waited, None, m), m]
    for decode, tiles in ((60e-3, 2e-3), (62e-3, 4e-3)):
        out += [sp("decode", 1e-3, decode), sp("tile_sums", 1e-4, tiles)]
    stepper = sp("setup.stepper", 0.5)
    out += [sp("setup.lattice", 1.25), sp("setup.lattice", 1.5),
            sp("setup.kernels", 0.25, parent=stepper, built=False), stepper,
            sp("setup.kernels", 2.0, built=True)]
    return out


WANT = {"launch_self_us": 1e6 * 4 * 25e-6 / 4,
        "step_loop_us": 1e6 * (240e-6 - 100e-6) / 4,
        "count_ms": 13.0, "measure_wait_ms": 3.0, "decode_ms": 61.0,
        "tile_sum_ms": 3.0, "init_s": 1.25 + 1.5 + 0.5 + 2.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_planted_record(name, monkeypatch):
    record = planted()
    monkeypatch.setattr(profiling, "spans", lambda: list(record))
    assert load(ROOT, "metrics", name).read(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_its_spans(name, monkeypatch):
    reader = load(ROOT, "metrics", name)
    monkeypatch.setattr(profiling, "spans", list)
    assert reader.read(None) is None
    # Spans that are there but carry nothing to read: CPU runs launch
    # nothing and record no device events.
    monkeypatch.setattr(profiling, "spans", lambda: [
        sp("advance", 1e-4, launches=0),
        sp("launch", 1e-5, launches=0),
        sp("count", 1e-4), sp("decode", 1e-3), sp("tile_sums", 1e-4)])
    if name not in ("measure_wait_ms", "init_s"):
        assert reader.read(None) is None
    # A program that keeps no record of spans (an older one).
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(None) is None
