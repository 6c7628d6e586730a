"""Files and lines of the port over row slabs against the JAX package's on
the conftest's 8 virtual CPU devices: the per-shard dumps
(io.dump_lattice_sharded, Simulation.dump, the CLI's -o), -c lines
computed slab by slab, checkpoints saved at one slab count and resumed at
another in either package, the CLI's --devs and --halo-overlap lines,
and the slab-by-slab observables (energies, Fourier partials, overlaps).

Lattices are made with numpy from a seed. Every comparison is of an
integer, a line or a file's bytes: no tolerance. Every file goes to
tmp_path.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import io as jio
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.parallel import make_mesh as jmake_mesh
from ising_tpu_torch import SimConfig, cli
from ising_tpu_torch import io as lio
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.lattice import full_to_compact

CPU = torch.device("cpu")


def _planes(seed, Y, X):
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


@contextlib.contextmanager
def _cwd(d):
    old = os.getcwd()
    os.chdir(d)
    try:
        yield
    finally:
        os.chdir(old)


# -- per-shard dumps ---------------------------------------------------------

@pytest.mark.parametrize("path", ["lat.txt", "lattice", "a.b.hex"])
def test_shard_path_matches_jax(path):
    for k in (0, 7, 12):
        assert lio._shard_path(path, k) == jio._shard_path(path, k)


@pytest.mark.parametrize("fmt", ["hex", "txt"])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_dump_bytes_match_jax(tmp_path, fmt, n):
    """One file per slab, byte for byte the JAX package's per-shard files
    on an n-device mesh; each file loads alone as its slab, and the
    stitching loader gives back the lattice."""
    full = np.random.RandomState(3 + n).randint(0, 2, (32, 16)).astype(
        np.uint8)
    b, w = full_to_compact(torch.from_numpy(full))
    jb, jw = (jnp.asarray(x.numpy()) for x in (b, w))
    if n > 1:
        sh = NamedSharding(jmake_mesh(n), P("rows", None))
        jb, jw = jax.device_put(jb, sh), jax.device_put(jw, sh)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = jio.dump_lattice_sharded(str(tmp_path / "j" / "lat.txt"), jb, jw,
                                    fmt=fmt)
    L = 32 // n
    slabs = (b, w) if n == 1 else ([b[k * L:(k + 1) * L] for k in range(n)],
                                   [w[k * L:(k + 1) * L] for k in range(n)])
    got = lio.dump_lattice_sharded(str(tmp_path / "t" / "lat.txt"), *slabs,
                                   fmt=fmt)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    b0, w0 = lio.load_lattice(got[0], fmt=fmt, device="cpu")
    assert torch.equal(b0, b[:L]) and torch.equal(w0, w[:L])
    b2, w2 = lio.load_lattice_sharded(str(tmp_path / "t" / "lat.txt"),
                                      fmt=fmt, device="cpu")
    assert torch.equal(b2, b) and torch.equal(w2, w)
    jb2, _ = jio.load_lattice_sharded(str(tmp_path / "t" / "lat.txt"),
                                      fmt=fmt)
    np.testing.assert_array_equal(np.asarray(jb2), b.numpy())


def test_load_lattice_sharded_needs_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="no shard files match"):
        lio.load_lattice_sharded(str(tmp_path / "none.txt"), device="cpu")


@pytest.mark.parametrize("backend", ["xla", "bit1", "packed"])
def test_simulation_dump_writes_jax_shard_files(tmp_path, backend):
    kw = dict(nrows=16, ncols=64, temp=1.5, seed=9, backend=backend,
              ndev=8, niters=1)
    state = _planes(1, 16, 64)
    for sub, sim in (("j", JaxSimulation(JaxConfig(**kw), state=tuple(
            jnp.asarray(p) for p in state))),
            ("t", Simulation(SimConfig(device="cpu", **kw), state=state))):
        os.makedirs(tmp_path / sub)
        with _cwd(tmp_path / sub):
            sim.advance(2)
            sim._dump(2)
    files = _files(tmp_path / "t")
    assert len(files) == 8 and all("_shard" in f for f in files)
    assert files == _files(tmp_path / "j")


# -- the CLI -----------------------------------------------------------------

def _run(main, argv, d):
    out = io.StringIO()
    with _cwd(d), contextlib.redirect_stdout(out):
        code = main(argv)
    keep = [ln for ln in out.getvalue().splitlines()
            if not ln.startswith(("Kernel", "\tdevice:", "ising-tpu"))]
    return code, keep


@pytest.mark.parametrize("flags", [
    ["--backend", "bit1", "-x", "128", "-y", "32", "-n", "4", "-p", "2",
     "--devs", "4", "-o", "-c", "--checkpoint", "a.ck"],
    ["--backend", "xla", "-x", "64", "-y", "32", "-n", "3", "-p", "1",
     "--devs", "4", "-o", "-c", "--xsl", "16", "--ysl", "8"],
    ["--backend", "packed", "-x", "64", "-y", "128", "-n", "2", "-p", "1",
     "--devs", "4", "--halo-overlap", "-J", "0.2", "-c", "-o"],
    ["--backend", "xla", "-x", "64", "-y", "16", "-n", "4", "-p", "2",
     "--devs", "8", "-c", "--update=-0.5,2", "--field", "0.3",
     "--checkpoint", "b.ck"],
])
def test_cli_devs_lines_and_files_match_jax(tmp_path, flags):
    """The CLI's lines ("devices: N" too) and every file it writes (the
    per-shard dumps, the -c file, the checkpoint) equal the JAX CLI's
    with the same flags."""
    argv = flags + ["-t", "1.5", "-s", "31"]
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = _run(jcli.main, argv, tmp_path / "j")
    got = _run(cli.main, argv + ["--device", "cpu"], tmp_path / "t")
    assert got == want and want[0] == 0
    assert f"\tdevices: {flags[flags.index('--devs') + 1]}" in want[1]
    files = _files(tmp_path / "t")
    assert files == _files(tmp_path / "j")
    if "-o" in flags:
        assert sum("final_" in f for f in files) == 4


def test_cli_resume_takes_the_files_device_count(tmp_path):
    """--resume of a 4-slab checkpoint runs at 4 slabs, as the JAX CLI's
    does, with its lines; --devs is ignored on resume."""
    argv = ["--backend", "bit1", "-x", "64", "-y", "32", "-n", "2", "-p",
            "1", "-t", "1.5", "--devs", "4", "--checkpoint", "a.ck"]
    assert _run(cli.main, argv + ["--device", "cpu"], tmp_path)[0] == 0
    back = ["--resume", "a.ck", "--devs", "2"]
    want = _run(jcli.main, back, tmp_path)
    got = _run(cli.main, back + ["--device", "cpu"], tmp_path)
    assert got == want and "\tdevices: 4" in got[1]


# -- checkpoints across slab counts --------------------------------------------

@pytest.mark.parametrize("n_save,n_load", [(1, 4), (4, 1), (4, 2), (2, 8),
                                           (8, 8)])
def test_checkpoint_resumes_at_another_slab_count(tmp_path, n_save, n_load):
    """Saved by the port at n_save slabs: the JAX package's bytes at
    n_save devices; resumed at n_load slabs by the port (into another
    backend too) and by the JAX package, each continues the one-device
    trajectory."""
    base = dict(nrows=32, ncols=128, temp=1.5, seed=5, rng="philox")
    state = _planes(2, 32, 128)
    ref = Simulation(SimConfig(backend="bit1", device="cpu", **base),
                     state=state)
    ref.advance(4)
    s = Simulation(SimConfig(backend="bit1", ndev=n_save, device="cpu",
                             **base), state=state)
    s.advance(2)
    s.checkpoint(str(tmp_path / "t.ck"))
    j = JaxSimulation(JaxConfig(backend="bit1", ndev=n_save, **base),
                      state=tuple(jnp.asarray(p) for p in state))
    j.advance(2)
    j.checkpoint(str(tmp_path / "j.ck"))
    assert _files(tmp_path)["t.ck"] == _files(tmp_path)["j.ck"]
    for path, backends in (("t.ck", ("bit1", "packed", "xla")),
                           ("j.ck", ("bit1",))):
        p = str(tmp_path / path)
        assert Simulation.from_checkpoint(p, device="cpu").cfg.ndev == n_save
        for backend in backends:
            r = Simulation.from_checkpoint(p, ndev=n_load, device="cpu",
                                           backend=backend)
            assert r.cfg.ndev == n_load and r.step == 2
            assert isinstance(r.black, list) == (n_load > 1)
            r.advance(2)
            for a, b in zip(r.bits(), ref.bits()):
                assert torch.equal(a, b)
    jr = JaxSimulation.from_checkpoint(str(tmp_path / "t.ck"), ndev=n_load)
    jr.advance(2)
    for a, b in zip(jr.bits(), ref.bits()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_checkpoint_of_a_dense_run_over_slabs_matches_jax(tmp_path):
    """The decode path of the checkpoint (dense storage): each chunk of
    the file gathered from the slabs it spans; the JAX package's bytes."""
    base = dict(nrows=64, ncols=64, temp=1.5, seed=2, backend="dense",
                rng="threefry13", ndev=4)
    state = _planes(3, 64, 64)
    s = Simulation(SimConfig(device="cpu", **base), state=state)
    s.advance(1)
    s.checkpoint(str(tmp_path / "t.ck"))
    j = JaxSimulation(JaxConfig(**base),
                      state=tuple(jnp.asarray(p) for p in state))
    j.advance(1)
    j.checkpoint(str(tmp_path / "j.ck"))
    files = _files(tmp_path)
    assert files["t.ck"] == files["j.ck"]


# -- observables slab by slab -------------------------------------------------

@pytest.mark.parametrize("backend,extra", [
    ("bit1", {}), ("bit1", dict(j_prob=0.3)), ("packed", dict(j_prob=0.3)),
    ("xla", dict(field=0.4)), ("dense", {})])
@pytest.mark.parametrize("ndev", [2, 8])
def test_observables_over_slabs_match_jax(backend, extra, ndev):
    """Energies (a slab's last row bonds to the next slab), up counts, the
    field's signed m, the Fourier partials and the -c sums, slab by slab,
    equal the JAX package's at ndev devices."""
    kw = dict(nrows=16, ncols=64, temp=1.8, seed=17, backend=backend,
              **extra)
    state = _planes(4, 16, 64)
    t = Simulation(SimConfig(ndev=ndev, device="cpu", **kw), state=state)
    j = JaxSimulation(JaxConfig(ndev=ndev, **kw),
                      state=tuple(jnp.asarray(p) for p in state))
    t.advance(2)
    j.advance(2)
    assert t.energy_total() == j.energy_total()
    assert t.energy() == j.energy()
    assert t.measure() == j.measure()
    for a, b in zip(t.fourier_partials(), j.fourier_partials()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t._energy_rows().numpy(),
                                  np.asarray(j._energy_rows()))


@pytest.mark.parametrize("backend", ["bit1", "packed"])
def test_corr_lines_over_slabs_when_slabs_are_short(tmp_path, backend):
    """-c reads MAX_CORR_LEN (128) rows below each slab: with 2-row slabs
    of a 16-row lattice the tail wraps the ring many times; the lines are
    the JAX package's at 8 devices and the port's at one."""
    kw = dict(nrows=16, ncols=64, temp=1.8, seed=17, backend=backend)
    state = _planes(5, 16, 64)
    for sub, sim in (
            ("j", JaxSimulation(JaxConfig(ndev=8, **kw), state=tuple(
                jnp.asarray(p) for p in state))),
            ("t", Simulation(SimConfig(ndev=8, device="cpu", **kw),
                             state=state)),
            ("one", Simulation(SimConfig(device="cpu", **kw), state=state))):
        os.makedirs(tmp_path / sub)
        with _cwd(tmp_path / sub):
            sim.advance(1)
            sim._append_corr(1)
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == \
        _files(tmp_path / "one")


def test_overlap_across_slab_counts_and_backends():
    """overlap_with on the words where both runs hold the same slabs, else
    through the decode path; the JAX package's q either way."""
    kw = dict(nrows=32, ncols=64, temp=2.0, backend="packed")
    sa, sb = _planes(6, 32, 64), _planes(7, 32, 64)
    a4 = Simulation(SimConfig(ndev=4, seed=1, device="cpu", **kw), state=sa)
    b4 = Simulation(SimConfig(ndev=4, seed=2, device="cpu", **kw), state=sb)
    b1 = Simulation(SimConfig(seed=2, device="cpu", **kw), state=sb)
    bx = Simulation(SimConfig(ndev=2, seed=2, device="cpu",
                              **dict(kw, backend="xla")), state=sb)
    ja = JaxSimulation(JaxConfig(ndev=4, seed=1, **kw),
                       state=tuple(jnp.asarray(p) for p in sa))
    jb = JaxSimulation(JaxConfig(ndev=4, seed=2, **kw),
                       state=tuple(jnp.asarray(p) for p in sb))
    for s in (a4, b4, b1, bx, ja, jb):
        s.advance(2)
    q = ja.overlap_with(jb)
    assert a4.overlap_with(b4) == a4.overlap_with(b1) == \
        a4.overlap_with(bx) == b1.overlap_with(a4) == q
    assert torch.equal(a4._overlap_neq_rows_with(b4),
                       a4._overlap_neq_rows_with(bx))


def test_slab_partials_join_on_the_first_slab_device():
    """Each observable's per-slab partials are joined into one tensor on
    the first slab's device, so a measurement reads back one tensor."""
    sim = Simulation(SimConfig(nrows=32, ncols=64, backend="bit1", ndev=8,
                               device="cpu", j_prob=0.2))
    for rows in (sim._up_rows_for(sim.black, sim.white), sim._energy_rows()):
        assert rows.shape == (32,) and rows.device == sim.device
    assert sim.measure()["up"] == int(sim._up_rows_for(sim.black,
                                                       sim.white).sum())
