"""The port's Simulation, run loop and CLI against the JAX package's
(bit1 backend, Pallas in interpret mode on the CPU). Log lines and
integer observables must be identical, apart from the timing line."""

import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import SimConfig, cli, interop
from ising_tpu_torch import config as tconfig
from ising_tpu_torch.driver import Simulation, exponential_print_steps, \
    reference_exp_times
from ising_tpu_torch.ops import available_backends, get_backend
from ising_tpu_torch.ops.bit1 import Bit1Backend
from ising_tpu_torch.ops.dense import DenseBackend
from ising_tpu_torch.ops.mxu import MxuBackend
from ising_tpu_torch.ops.packed import PackedBackend


def _logs(sim):
    lines = []
    sim.run(log=lines.append)
    return lines


def _same_logs(a, b):
    """Equal line for line, except the final timing line."""
    assert len(a) == len(b)
    assert a[-1].startswith("Kernel execution time") and \
        b[-1].startswith("Kernel execution time")
    assert a[:-1] == b[:-1]


RUNS = [
    dict(nrows=16, ncols=128, temp=1.8, seed=11, rng="threefry13",
         niters=6, print_freq=2),
    dict(nrows=8, ncols=64, temp=0.0, seed=12, rng="philox", niters=5,
         nwarmup=2, print_freq=1),
    dict(nrows=16, ncols=64, temp=2.5, seed=13, rng="philox7", niters=9,
         print_exp=True, temp_step=-1.5, temp_freq=4),
    dict(nrows=8, ncols=128, temp=1.2, seed=14, rng="threefry", niters=8,
         print_freq=2, tgt_magn=0.0),
]


@pytest.mark.parametrize("kw", RUNS)
def test_run_loop_lines_match_jax(kw):
    jsim = JaxSimulation(JaxConfig(backend="bit1", **kw))
    tsim = Simulation(SimConfig(backend="bit1", device="cpu", **kw))
    _same_logs(_logs(jsim), _logs(tsim))
    assert tsim.measure() == {k: v for k, v in jsim.measure().items()}
    jb, jw = (np.asarray(x) for x in (jsim.black, jsim.white))
    tb, tw = interop.to_numpy_words(tsim.black, tsim.white)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tw, jw)


def test_energy_rows_match_jax():
    gen = np.random.default_rng(5)
    for Y, W1 in ((4, 1), (6, 3), (10, 8)):
        b = gen.integers(0, 1 << 32, (Y, W1), dtype=np.uint64).astype(np.uint32)
        w = gen.integers(0, 1 << 32, (Y, W1), dtype=np.uint64).astype(np.uint32)
        tb, tw = interop.from_numpy_words(b, w, device="cpu")
        be = Bit1Backend(SimConfig(backend="bit1", device="cpu"))
        np.testing.assert_array_equal(
            be.energy_rows(tb, tw).numpy(),
            np.asarray(jobs.bit1_energy_row_sums(b, w)))
        np.testing.assert_array_equal(
            be.row_up_counts(tb, tw).numpy(),
            np.asarray(jobs.word_row_up_counts(b, w)))


def test_measure_and_energy_match_jax():
    kw = dict(nrows=16, ncols=128, temp=1.5, seed=21, niters=1)
    jsim = JaxSimulation(JaxConfig(backend="bit1", **kw))
    tsim = Simulation(SimConfig(backend="bit1", device="cpu", **kw))
    for _ in range(2):
        assert tsim.measure() == jsim.measure()
        assert tsim.energy_total() == jsim.energy_total()
        assert tsim.energy() == jsim.energy()
        jsim.advance(3)
        tsim.advance(3)


def test_set_temperature_switches_greedy():
    kw = dict(nrows=8, ncols=64, temp=1.5, seed=22, niters=1)
    jsim = JaxSimulation(JaxConfig(backend="bit1", **kw))
    tsim = Simulation(SimConfig(backend="bit1", device="cpu", **kw))
    assert tsim.backend.greedy is False
    for temp in (0.0, 2.0, -1.0):
        jsim.set_temperature(temp)
        tsim.set_temperature(temp)
        assert tsim.backend.greedy == (temp <= 0)
        jsim.advance(2)
        tsim.advance(2)
        jb, _ = (np.asarray(x) for x in (jsim.black, jsim.white))
        np.testing.assert_array_equal(
            interop.to_numpy_words(tsim.black, tsim.white)[0], jb)


def test_schedules_match_jax():
    from ising_tpu import driver as jdriver
    for n in (1, 16, 500, 5000):
        assert exponential_print_steps(n) == jdriver.exponential_print_steps(n)
        assert reference_exp_times(n) == jdriver.reference_exp_times(n)


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("rng", ["threefry13", "philox"])
def test_cli_prints_jax_magnetization_lines(rng, capsys):
    argv = ["--backend", "bit1", "-x", "128", "-y", "16", "-n", "6", "-p",
            "2", "-t", "1.7", "-s", "77", "--rng", rng]
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _mag_lines(capsys.readouterr().out)
    assert len(want) == 5 and got == want


@pytest.mark.parametrize("extra", [
    ["-J", "0.1"], ["--backend", "dense"], ["--xsl", "32", "--ysl", "8"],
    ["--devs", "2"], ["-o", "-p", "1"], ["-c", "-p", "1"],
    ["--resume", "x.ck"], ["--checkpoint", "x.ck"], ["--algo", "sw"],
    ["--algo", "sw", "--backend", "xla"], ["--pt", "1.0,2.0"],
    ["--profile", "tracedir"], ["--backend", "mxu", "-x", "256", "-y", "128"],
    ["-J", "0.5", "--j-seed", "3", "--rng", "hw"],
    ["--backend", "packed"],
])
def test_cli_unported_flags_exit_1(extra, capsys, tmp_path, monkeypatch):
    """Every flag of the JAX CLI runs in the port. -o, -c and --checkpoint
    write their files; --resume of a file that is not there exits 1 with
    the JAX CLI's message. -J and --xsl/--ysl run: -J takes effect, as the
    JAX package's CLI shows with the same flags, and a replica geometry
    that bit1's words cannot tile (xsl/2 = 16 against W1 = 1) exits 1 with
    the JAX package's wording. The packed, dense and mxu backends print
    the JAX package's magnetization lines. --algo sw runs on xla, with the
    JAX package's lines, and exits 1 on bit1 with the JAX package's
    wording. --pt prints the JAX CLI's per-rung, acceptance and
    round-trip lines. --devs runs over row slabs on the CPU, prints the
    JAX CLI's "devices" line and its magnetization lines. --profile DIR
    writes a torch.profiler trace file into DIR and prints the JAX CLI's
    "Wrote profiler trace to DIR" line and magnetization lines."""
    monkeypatch.chdir(tmp_path)
    argv = ["--backend", "bit1", "-x", "64", "-y", "8", "-n", "1",
            "--device", "cpu"]
    code = cli.main(argv + extra)
    out, err = capsys.readouterr()
    if extra[0] in ("-o", "-c", "--checkpoint"):
        assert code == 0 and "not yet ported" not in err
        want = {"-o": ["final_8x64.txt",
                       "lattice_8x64_T_0.226919_IT_00000001.txt"],
                "-c": [f"corr_8x64_T_0.226919_{tconfig.SEED_DEF}"],
                "--checkpoint": ["x.ck"]}[extra[0]]
        assert sorted(p.name for p in tmp_path.iterdir()) == want
    elif extra[0] == "--resume":
        assert code == 1
        assert jcli.main(extra) == 1
        assert capsys.readouterr().err == err
        assert err.startswith("ERROR: cannot resume from x.ck: ")
    elif extra[0] == "--backend":
        assert code == 0
        assert f"\tbackend: {extra[1]} (rng: threefry13)" in out
        assert jcli.main(argv[:-2] + extra + ["-p", "1"]) == 0
        want = _mag_lines(capsys.readouterr().out)
        assert cli.main(argv + extra + ["-p", "1"]) == 0
        assert _mag_lines(capsys.readouterr().out) == want
        assert len(want) == 3
    elif "-J" in extra:
        assert code == 0
        assert f"\tdisorder: P(antiferro link) = {extra[1]}" in out
        assert jcli.main(argv[:-2] + extra + ["-p", "1"]) == 0
        want = _mag_lines(capsys.readouterr().out)
        assert cli.main(argv + extra + ["-p", "1"]) == 0
        assert _mag_lines(capsys.readouterr().out) == want
    elif "--xsl" in extra:
        assert code == 1
        assert "xsl/2 (16) to divide ncols/64 (1)" in err
    elif extra[:2] == ["--algo", "sw"] and "xla" in extra:
        assert code == 0
        assert out.startswith("ising-tpu-torch run (Swendsen-Wang):")
        assert jcli.main(argv[:-2] + extra + ["-p", "1"]) == 0
        want = _mag_lines(capsys.readouterr().out)
        assert cli.main(argv + extra + ["-p", "1"]) == 0
        assert _mag_lines(capsys.readouterr().out) == want
        assert len(want) == 3
    elif extra[0] == "--devs":
        assert code == 0 and "not yet ported" not in err
        assert "\tdevices: 2\n" in out
        assert jcli.main(argv[:-2] + extra + ["-p", "1"]) == 0
        jout = capsys.readouterr().out
        assert "\tdevices: 2\n" in jout
        want = _mag_lines(jout)
        assert cli.main(argv + extra + ["-p", "1"]) == 0
        assert _mag_lines(capsys.readouterr().out) == want
        assert len(want) == 3
    elif extra[0] == "--pt":
        assert code == 0 and "not yet ported" not in err
        assert out.startswith("ising-tpu-torch parallel tempering:")
        assert jcli.main(argv[:-2] + extra) == 0
        keep = lambda text: [ln for ln in text.splitlines() if "T = " in ln
                             or ln.startswith(("Pair acceptance",
                                               "Completed round trips"))]
        want = keep(capsys.readouterr().out)
        assert keep(out) == want and len(want) == 4
    elif extra[:2] == ["--algo", "sw"]:
        assert code == 1
        assert "cluster updates operate on decoded planes; use " \
            "backend='xla'" in err
    else:
        assert extra == ["--profile", "tracedir"]
        assert code == 0 and err == ""
        assert [p.name for p in (tmp_path / "tracedir").iterdir()] \
            == ["trace.json"]
        assert "Wrote profiler trace to tracedir" in out.splitlines()
        assert cli.main(argv + extra + ["-p", "1"]) == 0
        got = capsys.readouterr().out
        assert jcli.main(argv[:-2] + extra + ["-p", "1"]) == 0
        jout = capsys.readouterr().out
        assert "Wrote profiler trace to tracedir" in jout.splitlines()
        want = _mag_lines(jout)
        assert _mag_lines(got) == want and len(want) == 3


def test_cli_runs_every_backend(capsys):
    """The CLI's default backend, xla, runs with no --backend; packed,
    dense and mxu (at mxu's 128-row fence) run as asked. None is refused
    as not ported."""
    assert cli.main(["-x", "64", "-y", "8", "-n", "2", "--device",
                     "cpu"]) == 0
    assert "backend: xla (rng: threefry13)" in capsys.readouterr().out
    for backend, rows in (("packed", "8"), ("dense", "8"), ("mxu", "128")):
        assert cli.main(["-x", "256", "-y", rows, "-n", "2", "--device",
                         "cpu", "--backend", backend, "--rng", "philox"]) == 0
        out, err = capsys.readouterr()
        assert f"backend: {backend} (rng: philox)" in out
        assert "not yet ported" not in err


def test_registry_and_config_fences():
    from ising_tpu_torch.ops.xla_ref import XlaBackend
    assert isinstance(get_backend(SimConfig(device="cpu")), XlaBackend)
    assert isinstance(get_backend(SimConfig(backend="packed", ncols=64)),
                      PackedBackend)
    assert isinstance(get_backend(SimConfig(backend="dense", ncols=64)),
                      DenseBackend)
    assert isinstance(get_backend(SimConfig(backend="mxu", ncols=256)),
                      MxuBackend)
    assert isinstance(get_backend(SimConfig(backend="bit1", ncols=64)),
                      Bit1Backend)
    # Item 7 is ported: row slabs construct, with the JAX package's own
    # checks of the slab height.
    assert SimConfig(backend="bit1", nrows=16, ncols=64, ndev=2,
                     halo_overlap=True).local_rows == 8
    for ndev, msg in ((3, "divide evenly over devices"),
                      (16, "slab height must be even")):
        with pytest.raises(ValueError, match=msg):
            SimConfig(backend="bit1", nrows=16, ncols=64, ndev=ndev)
        with pytest.raises(ValueError, match=msg):
            JaxConfig(backend="bit1", nrows=16, ncols=64, ndev=ndev)
    # Dumps and correlation output are ported: they construct, as the JAX
    # package's configs do.
    for kw in (dict(dump_lattice=True), dict(corr_out=True, rng="chacha6b")):
        cfg = SimConfig(backend="bit1", nrows=16, ncols=64, **kw)
        want = JaxConfig(backend="bit1", nrows=16, ncols=64, **kw)
        assert (cfg.dump_lattice, cfg.corr_out) == (want.dump_lattice,
                                                    want.corr_out)
    # Item 4 is ported: disorder and replicas construct, and the JAX
    # package's own checks of them still hold.
    cfg = SimConfig(backend="bit1", nrows=16, ncols=64, j_prob=0.1,
                    j_seed=3, xsl=2, ysl=8)
    assert (cfg.j_prob, cfg.j_seed, cfg.xsl, cfg.ysl) == (0.1, 3, 2, 8)
    for kw, msg in ((dict(j_prob=1.5), r"j_prob must be in \[0, 1\]"),
                    (dict(xsl=32), "both xsl and ysl"),
                    (dict(xsl=24, ysl=8), "xsl must be even and divide"),
                    (dict(xsl=32, ysl=6), "ysl must be even and divide")):
        with pytest.raises(ValueError, match=msg):
            SimConfig(backend="bit1", nrows=16, ncols=64, **kw)
    with pytest.raises(ValueError):
        SimConfig(backend="bit1", ncols=96)
    # The JAX package's own validation of the field and ChaCha widths.
    with pytest.raises(ValueError, match="10-class bit-serial accept"):
        SimConfig(backend="bit1", ncols=64, rng="chacha8", field=0.1)
    with pytest.raises(ValueError, match="u32-contract rng mode"):
        SimConfig(backend="packed", ncols=64, rng="hw", field=0.1)
    with pytest.raises(ValueError, match="not supported on the mxu"):
        SimConfig(backend="mxu", ncols=256, field=0.1)
    with pytest.raises(ValueError, match="multiple of 32"):
        SimConfig(ncols=48, rng="chacha6")
    for rng in ("chacha6b", "hw", "chacha8", "philox"):
        SimConfig(backend="xla", ncols=64, rng=rng, field=0.1)
    assert available_backends() == ("xla", "bit1", "packed", "dense", "mxu")


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(SimConfig(backend="bit1", nrows=8, ncols=64))
    with pytest.raises(RuntimeError):
        tconfig.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        interop.from_numpy_words(np.zeros((1, 1), np.uint32),
                                 np.zeros((1, 1), np.uint32))


def test_module_entry_point_runs_on_cpu():
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, "-m", "ising_tpu_torch", "--backend", "bit1", "-x",
         "64", "-y", "8", "-n", "2", "-p", "1", "-t", "1.5", "--device",
         "cpu"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Final   magnetization" in proc.stdout
    assert "flips/ns" in proc.stdout
