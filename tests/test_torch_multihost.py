"""Row slabs over processes (ising_tpu_torch/parallel/: initialize_multihost,
the process halo rows, launch.run_group) against one device, the
single-controller mesh and the JAX package.

Groups of 2 and 4 processes run over gloo on the CPU, each rank holding
its contiguous run of global slabs; every rank's slabs, integer
observables, CLI lines and per-slab dump files must equal the rows, the
values, the lines and the bytes of one device and of the single-controller
mesh with the same flags. One case is held against the JAX package's
sharded stepper at ndev 4. The ranks are spawned processes, so this file
imports JAX only inside the test that uses it, and its rank functions sit
at module level. Every comparison is of an integer, a line or a file's
bytes: no tolerance.
"""

import contextlib
import io
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from ising_tpu_torch import SimConfig, cli
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.parallel import mesh as mesh_mod
from ising_tpu_torch.parallel.launch import run_group

CPU = torch.device("cpu")
ITEM = "(ROADMAP.md §1, item 18)"

# name: (SimConfig fields but device, steps, numpy seed of the initial
# planes or None for the seeded init)
SIMS2 = {
    "xla, a slab a rank": (dict(nrows=64, ncols=64, temp=1.8, seed=3,
                                backend="xla", ndev=2), 5, 1),
    "xla philox, 2 slabs a rank": (dict(nrows=64, ncols=64, temp=1.8,
                                        backend="xla", rng="philox",
                                        ndev=4), 5, None),
    "xla field": (dict(nrows=32, ncols=64, temp=1.5, backend="xla",
                       field=0.2, ndev=4), 4, 2),
    "bit1 chacha6b": (dict(nrows=64, ncols=128, temp=1.5, backend="bit1",
                           rng="chacha6b", ndev=2), 5, None),
    "bit1 -J": (dict(nrows=64, ncols=128, temp=1.5, backend="bit1",
                     j_prob=0.3, ndev=4), 4, None),
    "bit1 halo_overlap": (dict(nrows=128, ncols=64, temp=1.5,
                               backend="bit1", ndev=4, halo_overlap=True),
                          4, 4),
    "bit1 replicas": (dict(nrows=32, ncols=512, temp=1.5, backend="bit1",
                           xsl=16, ysl=8, ndev=4), 3, None),
    "packed -J halo_overlap": (dict(nrows=128, ncols=64, temp=1.5,
                                    backend="packed", j_prob=0.2, ndev=4,
                                    halo_overlap=True), 3, None),
    "dense": (dict(nrows=32, ncols=64, temp=1.5, backend="dense", ndev=2),
              3, 5),
}
SIMS4 = {
    "xla, a slab a rank": (dict(nrows=64, ncols=64, temp=1.8, seed=3,
                                backend="xla", ndev=4), 5, 1),
    "xla philox, 2 slabs a rank": (dict(nrows=64, ncols=64, temp=1.8,
                                        backend="xla", rng="philox",
                                        ndev=8), 4, None),
    "bit1 -J": (dict(nrows=64, ncols=128, temp=1.5, backend="bit1",
                     j_prob=0.3, ndev=4), 4, None),
    "bit1 halo_overlap, 2 slabs a rank": (
        dict(nrows=256, ncols=64, temp=1.5, backend="bit1",
             rng="threefry13b", ndev=8, halo_overlap=True), 3, None),
}
CLIS2 = {
    "bit1 -J -o": ["--backend", "bit1", "-x", "128", "-y", "64", "-w", "2",
                   "-n", "6", "-p", "2", "-J", "0.3", "--devs", "2", "-o"],
    "xla field replicas": ["-x", "64", "-y", "32", "-n", "6", "-p", "3",
                           "--field", "0.2", "--xsl", "16", "--ysl", "8",
                           "--devs", "4"],
    "packed halo_overlap -m": ["--backend", "packed", "-x", "64", "-y",
                               "128", "-n", "8", "-p", "2", "-m", "0.9",
                               "--devs", "4", "--halo-overlap"],
}
CLIS4 = {
    "xla -e ramp": ["-x", "64", "-y", "64", "-n", "8", "-e", "--devs", "4",
                    "--update=-0.3,4"],
    "bit1 halo_overlap -o": ["--backend", "bit1", "-x", "64", "-y", "256",
                             "-n", "4", "-p", "2", "--devs", "8",
                             "--halo-overlap", "-o"],
}
COMMON = ["-t", "1.5", "-s", "31", "--device", "cpu"]


def _planes(seed, Y, X):
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


@contextlib.contextmanager
def _cwd(d):
    old = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(old)


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


def _cli(argv, d):
    """(exit code, lines but the timing line, stderr) of the port's CLI run
    in directory d."""
    os.makedirs(d, exist_ok=True)
    out, err = io.StringIO(), io.StringIO()
    with _cwd(d), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        code = cli.main(argv + COMMON)
    return (code, [ln for ln in out.getvalue().splitlines()
                   if not ln.startswith("Kernel execution")],
            err.getvalue())


def _simulate(kw, steps, seed, ndev=None):
    """A Simulation of the case (at another slab count where ndev is
    given), stepped."""
    if ndev is not None:
        kw = dict(kw, ndev=ndev, halo_overlap=False)
    state = None if seed is None else _planes(seed, kw["nrows"], kw["ncols"])
    sim = Simulation(SimConfig(device="cpu", **kw), state=state)
    sim.advance(steps)
    return sim


def _record(sim, dump_dir):
    os.makedirs(dump_dir, exist_ok=True)
    sim.dump(os.path.join(dump_dir, "lat.txt"))
    rec = {"slab0": sim.slab0, "black": [b.numpy() for b in sim.black],
           "white": [w.numpy() for w in sim.white],
           "measure": sim.measure(), "energy_total": sim.energy_total(),
           "energy": sim.energy()}
    if sim.cfg.xsl is not None:
        rec["replicas"] = sim.replica_magnetizations()
    return rec


def _refusals(tmp):
    """{what: the message} of everything refused over processes."""
    from ising_tpu_torch.cluster import SwendsenWang
    from ising_tpu_torch.tempering import ParallelTempering
    cfg = SimConfig(nrows=32, ncols=64, temp=1.5, ndev=2, j_prob=0.2,
                    device="cpu")
    sim = Simulation(cfg)
    calls = {
        "sw": lambda: SwendsenWang(SimConfig(nrows=32, ncols=64, ndev=2,
                                             device="cpu")),
        "pt": lambda: ParallelTempering(cfg, [1.0, 2.0]),
        "-c": lambda: Simulation(SimConfig(nrows=32, ncols=64, ndev=2,
                                           corr_out=True, device="cpu")),
        "checkpoint": lambda: sim.checkpoint(os.path.join(tmp, "a.ck")),
        "resume": lambda: Simulation.from_checkpoint(
            os.path.join(tmp, "a.ck"), device="cpu"),
        "bits": sim.bits,
        "links": sim.links,
        "overlap": lambda: sim.overlap_with(sim),
        "fourier": sim.fourier_partials,
    }
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = None
        except NotImplementedError as e:
            out[what] = str(e)
    for what, flags in (("cli sw", ["--algo", "sw", "--devs", "2"]),
                        ("cli pt", ["--pt", "1.0,2.0", "--devs", "2"]),
                        ("cli -c", ["-c", "--devs", "2"]),
                        ("cli checkpoint", ["--checkpoint", "b.ck",
                                            "--devs", "2"])):
        code, lines, err = _cli(["-x", "64", "-y", "32", "-n", "2"] + flags,
                                os.path.join(tmp, what))
        out[what] = (code, err)
    for what, call in (("odd ndev", lambda: Simulation(SimConfig(
            nrows=36, ncols=64, ndev=3, device="cpu"))),
            ("mesh", lambda: mesh_mod.make_mesh(8, devices=[CPU] * 3))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    out["make_mesh"] = mesh_mod.make_mesh(4, device="cpu")
    return out


def _rank_work(rank, size, sims, clis, tmp, refusals):
    """One rank's share of a group's cases: {"sims": {name: record},
    "clis": {name: (code, lines, stderr)}, "refusals": ...}; the dumps
    and CLI files go under tmp."""
    out = {"sims": {}, "clis": {}, "refusals": None}
    for name, (kw, steps, seed) in sims.items():
        out["sims"][name] = _record(_simulate(kw, steps, seed),
                                    os.path.join(tmp, "dump", name))
    for name, argv in clis.items():
        out["clis"][name] = _cli(argv, os.path.join(tmp, "cli", name))
    if refusals:
        out["refusals"] = _refusals(os.path.join(tmp, f"refusals{rank}"))
    return out


def _group(tmp_path_factory, size, sims, clis, refusals):
    tmp = tmp_path_factory.mktemp(f"group{size}")
    outs = run_group(_rank_work, size, (sims, clis, str(tmp), refusals),
                     init_file=tmp / "rendezvous", timeout_s=240)
    return outs, tmp


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return _group(tmp_path_factory, 2, SIMS2, CLIS2, True)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    return _group(tmp_path_factory, 4, SIMS4, CLIS4, False)


def _check_sims(outs, tmp, name, case, tmp_path):
    kw, steps, seed = case
    one = _simulate(kw, steps, seed, ndev=1)
    many = _simulate(kw, steps, seed)     # the single-controller mesh
    L = kw["nrows"] // kw["ndev"]
    per = kw["ndev"] // len(outs)
    for rank, out in enumerate(outs):
        rec = out["sims"][name]
        assert rec["slab0"] == rank * per
        for k, (b, w) in enumerate(zip(rec["black"], rec["white"])):
            r = (rec["slab0"] + k) * L
            np.testing.assert_array_equal(b, one.black[r:r + L].numpy())
            np.testing.assert_array_equal(w, one.white[r:r + L].numpy())
            np.testing.assert_array_equal(b, many.black[r // L].numpy())
        assert rec["measure"] == one.measure() == many.measure()
        assert rec["energy_total"] == one.energy_total()
        assert rec["energy"] == one.energy()
        if "replicas" in rec:
            np.testing.assert_array_equal(rec["replicas"],
                                          one.replica_magnetizations())
    many.dump(str(tmp_path / "lat.txt"))
    got = _files(tmp / "dump" / name)
    assert len(got) == kw["ndev"]
    assert got == _files(tmp_path)


def _check_cli(outs, tmp, name, argv, tmp_path):
    """Every rank's lines equal the single-controller run's with the same
    flags, and its files; --devs 1 gives the same lines but the devices
    line."""
    want = _cli(argv, tmp_path / "many")
    one = _cli(argv[:argv.index("--devs")]
               + argv[argv.index("--devs") + 2:], tmp_path / "one")
    assert want[0] == 0
    for out in outs:
        assert out["clis"][name] == want
    assert [ln for ln in want[1] if "devices:" not in ln] == \
        [ln for ln in one[1] if "devices:" not in ln]
    assert _files(tmp / "cli" / name) == _files(tmp_path / "many")


# -- initialize_multihost and the mesh of a process ----------------------------

def test_initialize_multihost_passthrough(monkeypatch):
    """initialize_multihost forwards its keywords to
    torch.distributed.init_process_group (the twin of the JAX package's
    hook and its test), gloo on the CPU unless a backend is given."""
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    mesh_mod.initialize_multihost(device="cpu", init_method="tcp://host:1234",
                                  world_size=2, rank=0)
    mesh_mod.initialize_multihost(device="cpu", backend="mpi", rank=1,
                                  timeout=timedelta(seconds=60))
    assert calls == [
        {"init_method": "tcp://host:1234", "world_size": 2, "rank": 0,
         "backend": "gloo"},
        {"backend": "mpi", "rank": 1, "timeout": timedelta(seconds=60)}]


def test_initialize_multihost_takes_nccl_for_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)
    mesh_mod.initialize_multihost(world_size=1, rank=0)
    assert calls == [{"world_size": 1, "rank": 0, "backend": "nccl"}]


def test_initialize_multihost_on_cuda_needs_a_card(monkeypatch):
    """No fallback: a CUDA group without a card raises before joining."""
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_mod.initialize_multihost(device="cuda:1", world_size=2, rank=1)
    assert calls == []


@pytest.mark.parametrize("rank", [0, 1])
def test_make_mesh_gives_a_process_its_share(monkeypatch, rank):
    monkeypatch.setattr(mesh_mod, "process_group", lambda: (rank, 2))
    assert mesh_mod.make_mesh(4, device="cpu") == [CPU, CPU]
    assert mesh_mod.make_mesh(2, devices=[CPU] * 3) == [CPU]
    assert mesh_mod.first_slab([CPU, CPU]) == 2 * rank
    # the JAX refusal, counted over the group
    with pytest.raises(ValueError, match="requested 8 devices, only 6 "
                                         "present"):
        mesh_mod.make_mesh(8, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="do not split over 2 processes"):
        mesh_mod.make_mesh(3, device="cpu")
    cfg = SimConfig(nrows=32, ncols=64, ndev=4, device="cpu")
    assert mesh_mod.slab_devices(cfg) == [CPU, CPU]
    with pytest.raises(ValueError, match="a mesh of 4 devices for ndev = 4 "
                                         "over 2 processes"):
        mesh_mod.slab_devices(cfg, [CPU] * 4)
    with pytest.raises(NotImplementedError, match="over 2 processes"):
        mesh_mod.refuse_over_processes("it")


def test_without_a_group_nothing_is_summed():
    x = torch.arange(5, dtype=torch.int64)
    assert mesh_mod.process_group() == (0, 1)
    assert mesh_mod.all_sum(x) is x
    mesh_mod.refuse_over_processes("it")


# -- the launcher's deadline ---------------------------------------------------

def _fail_on_rank_1(rank, size):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def _hang_on_rank_1(rank, size):
    if rank == 1:
        time.sleep(600)
    return rank


def test_run_group_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_group(_fail_on_rank_1, 2, init_file=tmp_path / "g",
                  timeout_s=60)


def test_run_group_kills_a_group_past_its_deadline(tmp_path):
    """Rank 1 never returns: the group is killed at its deadline. (On a
    loaded host rank 0 may not have joined by then either.)"""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError,
                       match=r"ranks \[(0, )?1\] had not finished"):
        run_group(_hang_on_rank_1, 2, init_file=tmp_path / "g", timeout_s=8)
    assert time.monotonic() - t0 < 30


# -- two processes -----------------------------------------------------------

@pytest.mark.parametrize("name", list(SIMS2))
def test_two_processes_equal_one_device(group2, name, tmp_path):
    _check_sims(*group2, name, SIMS2[name], tmp_path)


@pytest.mark.parametrize("name", list(CLIS2))
def test_two_processes_print_one_devices_lines(group2, name, tmp_path):
    _check_cli(*group2, name, CLIS2[name], tmp_path)


def test_two_processes_refuse_what_needs_the_whole_lattice(group2):
    for out in group2[0]:
        ref = out["refusals"]
        for what in ("sw", "pt", "-c", "checkpoint", "resume", "bits",
                     "links", "overlap", "fourier"):
            assert ref[what] is not None and ref[what].endswith(
                f"does not run over 2 processes yet {ITEM}"), (what, ref)
        for what in ("cli sw", "cli pt", "cli -c", "cli checkpoint"):
            code, err = ref[what]
            assert code == 1 and err.startswith("ERROR: ") \
                and ITEM in err, (what, err)
        assert ref["odd ndev"] == "ndev = 3 does not split over 2 processes"
        assert ref["mesh"] == "requested 8 devices, only 6 present"
        assert ref["make_mesh"] == [CPU, CPU]


# -- four processes ----------------------------------------------------------

@pytest.mark.parametrize("name", list(SIMS4))
def test_four_processes_equal_one_device(group4, name, tmp_path):
    _check_sims(*group4, name, SIMS4[name], tmp_path)


@pytest.mark.parametrize("name", list(CLIS4))
def test_four_processes_print_one_devices_lines(group4, name, tmp_path):
    _check_cli(*group4, name, CLIS4[name], tmp_path)


def test_four_processes_equal_the_jax_sharded_stepper(group4):
    """The 4-rank xla case against the JAX package's shard_map stepper on
    4 of the conftest's virtual CPU devices, from the same planes."""
    import jax.numpy as jnp

    from ising_tpu import SimConfig as JaxConfig
    from ising_tpu.driver import Simulation as JaxSimulation

    kw, steps, seed = SIMS4["xla, a slab a rank"]
    sim = JaxSimulation(JaxConfig(**kw), state=tuple(
        jnp.asarray(p) for p in _planes(seed, kw["nrows"], kw["ncols"])))
    sim.advance(steps)
    want = [np.asarray(p) for p in sim.bits()]
    L = kw["nrows"] // kw["ndev"]
    for rank, out in enumerate(group4[0]):
        rec = out["sims"]["xla, a slab a rank"]
        np.testing.assert_array_equal(rec["black"][0],
                                      want[0][rank * L:(rank + 1) * L])
        np.testing.assert_array_equal(rec["white"][0],
                                      want[1][rank * L:(rank + 1) * L])
        assert rec["energy_total"] == sim.energy_total()
