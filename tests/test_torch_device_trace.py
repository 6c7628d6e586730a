"""The device-trace summary: interval union, window, idle share, gaps."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from ising_tpu_torch import device_trace


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 2)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(4, 5), (0, 2), (1, 1.5)], 3.0),
    ([(0, 1), (1, 2), (5, 9)], 6.0),
])
def test_union_length(intervals, want):
    assert device_trace.union_length(intervals) == want


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def test_summarize_counts_only_the_window():
    k = "void (anonymous namespace)::bit1_sweep_kernel<1, 13, false>()"
    events = [
        _ev(device_trace.WINDOW, 100.0, 200.0, DeviceType.CPU),
        _ev(k, 90.0, 99.0, DeviceType.CUDA),        # before the window
        _ev(k, 110.0, 130.0, DeviceType.CUDA),
        _ev(k, 131.0, 151.0, DeviceType.CUDA),
        _ev("popcount", 160.0, 170.0, DeviceType.CUDA),
        _ev("popcount", 165.0, 175.0, DeviceType.CUDA),
    ]
    want = {"wall_us": 100.0, "device_busy_us": 55.0, "kernel_launches": 2,
            "device_us_by_name": {k: 40.0, "popcount": 20.0},
            "gap_after_kernel_us": {"n": 2, "median": 9.0, "p90": 9.0,
                                    "max": 9.0}}
    out = device_trace.summarize(events)
    assert {key: out[key] for key in want} == want
    assert out["idle_share"] == pytest.approx(0.45)
    # The device clock runs 50 us behind the host's: the window's mirror
    # on the device timeline still selects the same device work.
    shifted = [_ev(e.name, e.time_range.start - 50, e.time_range.end - 50,
                   e.device_type) if e.device_type == DeviceType.CUDA else e
               for e in events]
    shifted.append(_ev(device_trace.WINDOW, 60.0, 125.0, DeviceType.CUDA))
    out = device_trace.summarize(shifted)
    assert {key: out[key] for key in want} == want


def test_trace_runs_on_cpu(capsys):
    assert device_trace.main(["--size", "64", "-w", "2", "-n", "4", "-p",
                              "2", "--rng", "philox", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Final   magnetization" in out and "[trace] 64^2 philox" in out


def test_summarize_counts_both_bit1_kernels():
    """bit1_sweep launches bit1_sweep_kernel in the u32 modes and
    bit1_planes_kernel in the bit-plane modes: both count as launches."""
    p = "void (anonymous namespace)::bit1_planes_kernel<2, 6, 16, 0>()"
    events = [
        _ev(device_trace.WINDOW, 0.0, 100.0, DeviceType.CPU),
        _ev(p, 10.0, 20.0, DeviceType.CUDA),
        _ev(p, 21.0, 31.0, DeviceType.CUDA),
        _ev("popcount", 40.0, 45.0, DeviceType.CUDA),
    ]
    out = device_trace.summarize(events)
    assert out["kernel_launches"] == 2
    assert out["gap_after_kernel_us"] == {"n": 2, "median": 9.0, "p90": 9.0,
                                          "max": 9.0}
    assert not device_trace.is_kernel("popcount")


def test_trace_runs_packed_on_cpu(capsys):
    assert device_trace.main(["--size", "64", "-w", "2", "-n", "4", "-p",
                              "2", "--rng", "chacha8", "--backend", "packed",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[trace] 64^2 chacha8 on packed" in out
    assert device_trace.is_kernel(
        "void (anonymous namespace)::packed_sweep_kernel<2, 8, 0>(...)")


@pytest.mark.parametrize("backend,size,kernel", [
    ("dense", 64, "dense_sweep_kernel<1, 13>"),
    ("mxu", 256, "mxu_sweep_kernel<0, 10, 2>")])
def test_trace_runs_dense_and_mxu_on_cpu(backend, size, kernel, capsys):
    assert device_trace.main(["--size", str(size), "-w", "2", "-n", "4", "-p",
                              "2", "--rng", "philox", "--backend", backend,
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[trace] {size}^2 philox on {backend}" in out
    assert device_trace.is_kernel(
        f"void (anonymous namespace)::{kernel}(...)")


def test_summarize_times_the_parts_of_an_sw_update():
    """Each program span's device mirror (here sw_step's ising.sw.*
    ranges): its span, and the device time of the kernels inside it."""
    k = "(anonymous namespace)::label_{}_kernel(unsigned char const*, ...)"
    events = [
        _ev(device_trace.WINDOW, 100.0, 300.0, DeviceType.CPU),
        _ev("ising.sw.bonds", 110.0, 140.0, DeviceType.CUDA),
        _ev("elementwise", 110.0, 120.0, DeviceType.CUDA),
        _ev("elementwise", 125.0, 140.0, DeviceType.CUDA),
        _ev("ising.sw.label", 150.0, 200.0, DeviceType.CUDA),
        _ev(k.format("tile_roots"), 150.0, 160.0, DeviceType.CUDA),
        _ev(k.format("hook"), 190.0, 195.0, DeviceType.CUDA),
        _ev(k.format("flatten"), 196.0, 200.0, DeviceType.CUDA),
        _ev("ising.sw.flip", 210.0, 230.0, DeviceType.CUDA),
        _ev("elementwise", 210.0, 230.0, DeviceType.CUDA),
    ]
    out = device_trace.summarize(events)
    assert out["spans"] == {
        "sw.bonds": {"span_us": 30.0, "busy_us": 25.0},
        "sw.label": {"span_us": 50.0, "busy_us": 19.0},
        "sw.flip": {"span_us": 20.0, "busy_us": 20.0}}
    assert out["kernel_launches"] == 3
    assert out["gap_after_kernel_us"]["n"] == 3


def test_trace_runs_sw_on_cpu(capsys):
    assert device_trace.main(["--algo", "sw", "--size", "32", "-n", "2",
                              "-p", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[trace] 32^2 Swendsen-Wang" in out
    assert '"sw": {' in out.splitlines()[-1]


@pytest.mark.parametrize("fused,block_rows,want", [
    (None, None, ("packed_sweep", 2)),
    ("1", None, ("packed_sweep", 2)),     # 64 rows: one block, not fusable
    ("1", "8", ("packed_fused_step", 1)),
    ("2", "8", ("packed_fused_step_manual", 1)),
])
def test_fused_path_expects_one_launch_a_step(fused, block_rows, want,
                                              monkeypatch, capsys):
    """Under ISING_TPU_FUSED=1|2 on packed, where the fused step applies,
    the trace expects one launch of the fused kernel a step and counts
    its kernel's launches and gaps."""
    for name, value in (("ISING_TPU_FUSED", fused),
                        ("ISING_TPU_FUSED_BY", block_rows)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    cfg = device_trace.SimConfig(nrows=64, ncols=64, backend="packed",
                                 rng="philox", device="cpu")
    assert device_trace.step_launches(cfg) == want
    assert device_trace.is_kernel(
        "void (anonymous namespace)::packed_fused_kernel<0, 10, 0, true>"
        "((anonymous namespace)::FusedArgs)")
    if fused == "2":
        assert device_trace.main(["--size", "64", "-w", "2", "-n", "4", "-p",
                                  "2", "--rng", "philox", "--backend",
                                  "packed", "--device", "cpu"]) == 0
        assert "(of 4 packed_fused_step_manual launches)" in (
            capsys.readouterr().out)


def test_summarize_names_an_idle_gap_by_its_program_span():
    """A device that idles while the host waits for a measurement: the gap
    is named by the innermost program span (ising.*) on the host's row at
    its middle, per device, longest first."""
    k = "void (anonymous namespace)::bit1_sweep_kernel<0, 10, false>()"
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev(device_trace.WINDOW, 0.0, 100.0, cpu),
        _ev("ising.advance", 1.0, 10.0, cpu),
        _ev("ising.launch", 6.0, 8.0, cpu),
        _ev("ising.measure", 40.0, 100.0, cpu),
        _ev("ising.count", 41.0, 45.0, cpu),
        _ev("ising.wait", 70.0, 99.0, cpu),
        _ev(k, 5.0, 38.0, gpu),
        _ev("popcount", 42.0, 60.0, gpu),
        _ev("ising.count", 42.0, 60.0, gpu),
    ]
    out = device_trace.summarize(events)
    assert out["idle_gaps"] == [
        {"span": "wait", "device": 0, "us": 40.0},
        {"span": "advance", "device": 0, "us": 5.0},
        {"span": "measure", "device": 0, "us": 4.0}]
    assert out["spans"] == {"count": {"span_us": 18.0, "busy_us": 18.0}}
    assert out["device_busy_us"] == 51.0
