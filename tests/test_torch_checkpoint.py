"""The port's v2 checkpoint and --resume (ising_tpu_torch/checkpoint.py,
Simulation.checkpoint / from_checkpoint, the CLI's -o -c --checkpoint and
--resume) against the JAX package's: the same bytes, and either package
resumes the other's file and continues the same trajectory bit for bit,
into any backend and after a temperature ramp.

States are made with numpy from a seed, or stepped by the JAX package's
xla backend (no Pallas sweep runs here but the CLI's on the small
lattices of test_cli_outputs_match_jax). Every file goes to tmp_path.
"""

import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import checkpoint as jck
from ising_tpu import cli as jcli
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import SimConfig, checkpoint, cli
from ising_tpu_torch.driver import Simulation


def _planes(seed, Y, X):
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def _bits(sim):
    return tuple(np.asarray(p) for p in sim.bits())


def _body(path):
    return path.read_bytes()[jck.read_checkpoint_meta(str(path))
                             ["_body_offset"]:]


EVERY_FIELD = dict(nrows=64, ncols=512, temp=1.25, alpha=0.5, seed=7,
                   backend="packed", rng="chacha8", nwarmup=3, niters=9,
                   print_freq=2, print_exp=True, exp_thinned=True,
                   tgt_magn=0.5, temp_step=-0.125, temp_freq=4, j_prob=0.25,
                   j_seed=11, field=0.5, xsl=64, ysl=16, ndev=1,
                   halo_overlap=True, dump_lattice=True, corr_out=True)


def test_config_json_is_the_jax_config_json():
    """The header's config: the JAX package's 24 fields in its order, with
    its value types; `device` never goes to disk and the reader names it."""
    jfields = [f.name for f in dataclasses.fields(JaxConfig)]
    pfields = [f.name for f in dataclasses.fields(SimConfig)]
    assert pfields == jfields + ["device"] and len(jfields) == 24
    assert set(EVERY_FIELD) == set(jfields)
    cfg = SimConfig(**EVERY_FIELD, device="cpu")
    text = cfg.to_json()
    assert text == JaxConfig(**EVERY_FIELD).to_json()
    assert "device" not in json.loads(text)
    assert SimConfig.from_json(text, device="cpu") == cfg
    assert SimConfig.from_json(text).device == "cuda"
    assert JaxConfig.from_json(text) == JaxConfig(**EVERY_FIELD)


@pytest.mark.parametrize("backend, Y, X", [
    ("bit1", 64, 512),       # the word shuffle (W1 = 8)
    ("bit1", 16, 128),       # W1 = 2: the decode path
    ("xla", 16, 128), ("packed", 16, 128), ("dense", 16, 128),
    ("mxu", 128, 256)])
def test_checkpoint_bytes_match_jax(tmp_path, backend, Y, X):
    """Simulation.checkpoint writes the JAX package's bytes for the same
    state, step, temperature and config, on every backend."""
    planes = _planes(1, Y, X)
    kw = dict(nrows=Y, ncols=X, temp=1.5, seed=5, backend=backend,
              niters=3)
    Simulation(SimConfig(**kw, device="cpu"), state=planes, step0=7,
               temp=2.25).checkpoint(str(tmp_path / "p"))
    JaxSimulation(JaxConfig(**kw), state=_j(planes), step0=7,
                  temp=2.25).checkpoint(str(tmp_path / "j"))
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_streamed_save_and_load_match_jax(tmp_path):
    """save_checkpoint and save_checkpoint_streamed in chunks of 6 of 16
    rows (the last chunk short) write the JAX package's bytes; both
    packages read either back, planes and metadata; the plain load gives
    uint8 planes on the device asked for."""
    planes = _planes(2, 16, 96)
    cfg = dict(nrows=16, ncols=96, temp=1.5)
    checkpoint.save_checkpoint(str(tmp_path / "p"), *planes, step=3,
                               temp=1.5, cfg=SimConfig(**cfg))
    jck.save_checkpoint(str(tmp_path / "j"), *_j(planes), step=3, temp=1.5,
                        cfg=JaxConfig(**cfg))
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    for save, dst, conf in ((checkpoint.save_checkpoint_streamed, "ps",
                             SimConfig(**cfg)),
                            (jck.save_checkpoint_streamed, "js",
                             JaxConfig(**cfg))):
        save(str(tmp_path / dst), lambda r0, r1: (planes[0][r0:r1],
                                                  planes[1][r0:r1]),
             16, 96, step=3, temp=1.5, cfg=conf, chunk_rows=6)
    assert (tmp_path / "ps").read_bytes() == (tmp_path / "js").read_bytes()
    assert (tmp_path / "ps").read_bytes() != (tmp_path / "p").read_bytes()
    b, w, step, temp, c = checkpoint.load_checkpoint(str(tmp_path / "js"),
                                                     device="cpu")
    assert b.dtype == torch.uint8 and b.device.type == "cpu"
    assert np.array_equal(b.numpy(), planes[0])
    assert np.array_equal(w.numpy(), planes[1])
    assert (step, temp, c) == (3, 1.5, SimConfig(**cfg, device="cpu"))
    jb, jw, *_ = jck.load_checkpoint(str(tmp_path / "ps"))
    assert np.array_equal(np.asarray(jb), planes[0])
    meta = checkpoint.read_checkpoint_meta(str(tmp_path / "ps"), "cpu")
    want = jck.read_checkpoint_meta(str(tmp_path / "ps"))
    assert meta["chunk_rows"] == 6 and {
        k: v for k, v in meta.items() if k != "cfg"} == {
        k: v for k, v in want.items() if k != "cfg"}


BASE = dict(nrows=64, ncols=512, temp=1.8, seed=11, rng="threefry13",
            niters=3)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's xla run: its checkpoint after 3 steps, the one
    after 3 more, and its lattice then."""
    d = tmp_path_factory.mktemp("jax_run")
    sim = JaxSimulation(JaxConfig(**BASE))
    sim.advance(3)
    sim.checkpoint(str(d / "first"))
    sim.advance(3)
    sim.checkpoint(str(d / "second"))
    return d, _bits(sim)


@pytest.mark.parametrize("backend", ["xla", "bit1", "packed", "dense"])
def test_port_resumes_jax_checkpoint(tmp_path, jax_run, backend):
    """The port resumes the JAX package's xla checkpoint into each backend
    and continues the JAX trajectory: the same lattice after 3 more steps,
    and a checkpoint with the JAX package's body (its bytes, on xla)."""
    d, want = jax_run
    sim = Simulation.from_checkpoint(str(d / "first"), backend=backend,
                                     device="cpu")
    assert sim.step == 3 and sim.cfg.backend == backend
    assert sim.device.type == "cpu" and sim.black.device.type == "cpu"
    sim.advance(3)
    for a, b in zip(_bits(sim), want):
        assert np.array_equal(a, b)
    sim.checkpoint(str(tmp_path / "p"))
    assert _body(tmp_path / "p") == _body(d / "second")
    if backend == "xla":
        assert (tmp_path / "p").read_bytes() == (d / "second").read_bytes()


@pytest.mark.parametrize("backend", ["xla", "bit1", "packed", "dense"])
def test_jax_resumes_port_checkpoint(tmp_path, jax_run, backend):
    """The JAX package resumes the port's checkpoint from each backend (its
    header names that backend; the JAX resume runs on xla) and continues
    the port's trajectory; the port's own resume does the same."""
    d, want = jax_run
    sim = Simulation(SimConfig(**dict(BASE, backend=backend), device="cpu"))
    sim.advance(3)
    sim.checkpoint(str(tmp_path / "p"))
    assert _body(tmp_path / "p") == _body(d / "first")
    jax = JaxSimulation.from_checkpoint(str(tmp_path / "p"), backend="xla")
    jax.advance(3)
    port = Simulation.from_checkpoint(str(tmp_path / "p"), device="cpu")
    assert port.cfg.backend == backend
    port.advance(3)
    for a, b, c in zip(_bits(jax), _bits(port), want):
        assert np.array_equal(a, c) and np.array_equal(b, c)


def test_resume_into_another_backend_and_mxu(tmp_path):
    """Resume continues the straight run on mxu (128 x 256, its smallest
    lattice), and an mxu checkpoint resumed on bit1 continues it too."""
    kw = dict(nrows=128, ncols=256, temp=1.8, seed=4, rng="philox")
    straight = Simulation(SimConfig(**kw, backend="mxu", device="cpu"))
    straight.advance(4)
    sim = Simulation(SimConfig(**kw, backend="mxu", device="cpu"))
    sim.advance(2)
    sim.checkpoint(str(tmp_path / "ck"))
    for backend in ("mxu", "bit1"):
        resumed = Simulation.from_checkpoint(str(tmp_path / "ck"),
                                             backend=backend, device="cpu")
        resumed.advance(2)
        for a, b in zip(_bits(resumed), _bits(straight)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("rng, backend", [("threefry13", "xla"),
                                          ("chacha6b", "bit1"),
                                          ("threefry13", "packed")])
def test_checkpoint_preserves_ramped_temp(tmp_path, rng, backend):
    """A run that starts at T = 0 (the greedy quench) and ramps up is
    checkpointed at T = 1.5: the resumed Simulation takes the file's
    temperature and its backend's accept follows it (greedy off; the k-bit
    thresholds of the bit-plane mode), so the resumed run of the same
    ramp equals one straight run; a resume left at the config's T = 0
    does not. The JAX package resumes the port's file to the same lattice
    (threefry13, on its xla backend)."""
    kw = dict(nrows=16, ncols=128, temp=0.0, seed=3, rng=rng,
              backend=backend, niters=4, print_freq=2, temp_step=0.75,
              temp_freq=2)
    quiet = dict(log=lambda *a: None)
    straight = Simulation(SimConfig(**dict(kw, niters=8), device="cpu"))
    straight.run(**quiet)
    assert straight.temp == 3.0
    sim = Simulation(SimConfig(**kw, device="cpu"))
    sim.run(**quiet)
    sim.checkpoint(str(tmp_path / "ck"))
    resumed = Simulation.from_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert resumed.temp == 1.5 and resumed.cfg.temperature == 0.0
    assert not resumed.backend.greedy
    fresh = Simulation(SimConfig(**dict(kw, temp=1.5), device="cpu"))
    if hasattr(fresh.backend, "accept"):
        assert repr(resumed.backend.accept) == repr(fresh.backend.accept)
    stale = Simulation(resumed.cfg, storage=(resumed.black.clone(),
                                             resumed.white.clone()),
                       step0=resumed.step)
    resumed.run(**quiet)
    stale.advance(4)
    assert resumed.temp == 3.0
    assert all(np.array_equal(a, b)
               for a, b in zip(_bits(resumed), _bits(straight)))
    assert not all(np.array_equal(a, b)
                   for a, b in zip(_bits(stale), _bits(straight)))
    if rng == "threefry13":
        jax = JaxSimulation.from_checkpoint(str(tmp_path / "ck"),
                                            backend="xla")
        assert jax.temp == 1.5
        jax.run(**quiet)
        assert all(np.array_equal(a, b)
                   for a, b in zip(_bits(jax), _bits(straight)))


def _faulty(tmp_path, fault):
    """A checkpoint file with one fault, written by the JAX package."""
    path = tmp_path / "ck"
    planes = _planes(3, 8, 64)
    jck.save_checkpoint(str(path), *_j(planes), step=1, temp=1.0,
                        cfg=JaxConfig(nrows=8, ncols=64))
    data = path.read_bytes()
    if fault == "magic":
        data = b"NOTACKPT" + data[8:]
    elif fault == "npz":
        data = b"PK\x03\x04" + data[4:]
    elif fault == "truncated":
        data = data[:-5]
    elif fault in ("geometry", "version"):
        hlen = int(np.frombuffer(data[8:12], "<u4")[0])
        meta = json.loads(data[12:12 + hlen])
        if fault == "geometry":
            meta["nrows"] = 16
        else:
            meta["version"] = 3
        header = json.dumps(meta).encode()
        data = (data[:8] + np.uint32(len(header)).tobytes() + header
                + data[12 + hlen:])
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("fault", ["magic", "npz", "truncated", "geometry",
                                   "version"])
def test_checkpoint_errors_match_jax(tmp_path, capsys, fault):
    """A bad magic, a v1 .npz, a truncated body, a header whose geometry
    disagrees with its config, an unknown version: ValueError with the JAX
    package's words, and --resume exits 1 with the JAX CLI's message."""
    path = _faulty(tmp_path, fault)
    with pytest.raises(ValueError) as want:
        jck.load_checkpoint_state(path)
    with pytest.raises(ValueError) as got:
        checkpoint.load_checkpoint_state(path, device="cpu")
    assert str(got.value) == str(want.value)
    capsys.readouterr()
    assert jcli.main(["--resume", path]) == 1
    jax_err = capsys.readouterr().err
    assert cli.main(["--resume", path, "--device", "cpu"]) == 1
    assert capsys.readouterr().err == jax_err
    assert jax_err.startswith(f"ERROR: cannot resume from {path}: ")


def test_save_shape_errors_match_jax(tmp_path):
    """A chunk of the wrong shape from decode_rows or packed_rows: the JAX
    package's ValueError."""
    cfgs = (SimConfig(nrows=8, ncols=64), JaxConfig(nrows=8, ncols=64))
    bad = np.zeros((3, 5), np.uint8)
    for kw in (dict(decode_rows=lambda r0, r1: (bad, bad)),
               dict(decode_rows=None, packed_rows=lambda r0, r1: (bad, bad))):
        msgs = []
        for save, cfg in zip((checkpoint.save_checkpoint_streamed,
                              jck.save_checkpoint_streamed), cfgs):
            with pytest.raises(ValueError) as e:
                save(str(tmp_path / "x"), nrows=8, ncols=64, step=0,
                     temp=1.0, cfg=cfg, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "expected (8, " in msgs[0]


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("backend, Y, X", [
    ("xla", 64, 512), ("bit1", 64, 512), ("packed", 64, 512),
    ("dense", 64, 512), ("mxu", 128, 256)])
def test_cli_outputs_match_jax(tmp_path, capsys, backend, Y, X):
    """The CLI's -o -c --checkpoint, then --resume with --checkpoint: every
    file (the dumps of each measurement, the final dumps, the -c file both
    runs append to, both checkpoints) equal to the JAX CLI's with the same
    flags, byte for byte; the port's lines name each file as the JAX
    CLI's do."""
    first = ["--backend", backend, "-x", str(X), "-y", str(Y), "-n", "4",
             "-p", "2", "-t", "1.5", "--rng", "threefry13", "-o", "-c",
             "--checkpoint", "a.ck"]
    second = ["--resume", "a.ck", "--checkpoint", "b.ck"]
    outs = []
    for main, d, extra in ((jcli.main, tmp_path / "j", []),
                           (cli.main, tmp_path / "p", ["--device", "cpu"])):
        d.mkdir()
        with contextlib.chdir(d):
            assert main(first + extra) == 0
            assert main(second + extra) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("Wrote")])
    assert outs[0] == outs[1] and len(outs[1]) == 4
    want, got = _files(tmp_path / "j"), _files(tmp_path / "p")
    assert list(got) == list(want) and len(got) == 6
    for name in want:
        assert got[name] == want[name], name
