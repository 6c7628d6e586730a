"""The fused both-colors packed step (ISING_TPU_FUSED=1|2) in the port
against the JAX package.

packed_fused_step_reference and the wrappers packed_fused_step and
packed_fused_step_manual (on CPU tensors: the plain version) held bit for
bit against the JAX kernels pallas_packed.packed_fused_step and
packed_fused_step_manual(block_rows=...) in interpret mode, on words with
every bit random; PackedBackend.fusable against the JAX backend's, case by
case; Simulation and the CLI under the variable against the JAX package's
and against the port's own two-call path; the refusal of the block heights
at which the JAX manual kernel computes a wrong lattice, beside a test that
shows it doing so; and the wrappers' checks before and around a launch, on
stand-ins for CUDA tensors. Every compared value is an integer or a bit
pattern: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu.constants import BLACK, WHITE
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import pallas_packed as jpacked
from ising_tpu_torch import SimConfig, cli, interop
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import packed
from ising_tpu_torch.rng import threefry_stream_key

FUSED = (packed.packed_fused_step, packed.packed_fused_step_manual)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_fused_env(monkeypatch):
    monkeypatch.delenv("ISING_TPU_FUSED", raising=False)
    monkeypatch.delenv("ISING_TPU_FUSED_BY", raising=False)


def _words(gen, shape):
    return gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return interop.from_numpy_words(a, a, device="cpu")[0]


def _np(t):
    return interop.to_numpy_words(t, t)[0]


# (kernel, (H, ncols), block rows, mode, temp, field, row0): the JAX
# packed_fused_step at its own block height (three 256-row blocks in Philox
# and ChaCha, three 512-row ones in Threefry and hw, the fewest fusable
# takes), and packed_fused_step_manual at 8-row blocks over 3, 5 and 7
# blocks; W = 4 words, and W = 5 (80 columns, odd) outside ChaCha; T > 0,
# the greedy quench, the field in the u32 modes (hw refuses one); a row
# offset whose counters carry into the high word and wrap mod 2^32.
CASES = [
    ("fused", (768, 64), None, "philox", 1.5, 0.0, 0),
    ("fused", (768, 64), None, "philox", 0.0, 0.0, (1 << 32) - 5),
    ("fused", (768, 80), None, "philox7", 1.5, 0.3, 3),
    ("fused", (768, 64), None, "chacha8", 1.5, 0.0, (1 << 29) - 4),
    ("fused", (768, 64), None, "chacha8", 0.0, 0.0, 0),
    ("fused", (768, 64), None, "chacha8", 1.5, 0.2, 0),
    ("fused", (1536, 64), None, "threefry13", 1.5, 0.0, 0),
    ("fused", (1536, 64), None, "threefry13", 0.0, 0.2, 6),
    ("fused", (1536, 64), None, "hw", 1.5, 0.0, 0),
    ("fused", (1536, 64), None, "hw", 0.0, 0.0, (1 << 32) - 8),
    ("manual", (24, 64), 8, "threefry13", 1.5, 0.0, 0),
    ("manual", (24, 80), 8, "threefry", 0.0, 0.0, 2),
    ("manual", (40, 64), 8, "philox", 0.0, 0.0, (1 << 32) - 16),
    ("manual", (40, 64), 8, "hw", 1.5, 0.0, 0),
    ("manual", (56, 64), 8, "chacha8", 1.5, 0.3, 0),
    ("manual", (56, 80), 8, "philox", 1.5, -0.2, 0),
    ("manual", (56, 64), 8, "chacha4", 0.0, 0.0, 1 << 25),
]


def _jax_step(kind, black, white, thr, row0, step, block_rows, **kw):
    args = (jnp.asarray(black), jnp.asarray(white), jnp.asarray(thr),
            jnp.uint32(row0), jnp.uint32(step))
    if kind == "fused":
        out = jpacked.packed_fused_step(*args, interpret=True, **kw)
    else:
        out = jpacked.packed_fused_step_manual(*args, interpret=True,
                                               block_rows=block_rows, **kw)
    return tuple(np.asarray(o) for o in out)


def _jax_two_calls(black, white, thr, row0, step, **kw):
    """The JAX package's own two-call path: black, then white."""
    b, w = jnp.asarray(black), jnp.asarray(white)
    t, r, s = jnp.asarray(thr), jnp.uint32(row0), jnp.uint32(step)
    nb = jpacked.packed_sweep(b, w, w[-1:], w[:1], t, r, s, color=BLACK,
                              interpret=True, **kw)
    nw = jpacked.packed_sweep(w, nb, nb[-1:], nb[:1], t, r, s, color=WHITE,
                              interpret=True, **kw)
    return np.asarray(nb), np.asarray(nw)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[3]}-T{c[4]}-h{c[5]}" for c in CASES])
def test_fused_step_matches_jax(case):
    kind, (H, ncols), block_rows, mode, temp, field, row0 = case
    gen = np.random.default_rng(CASES.index(case) + 900)
    black, white = (_words(gen, (H, ncols // 16)) for _ in range(2))
    thr = ising.threshold_table(temp, field)
    step = int(gen.integers(0, 1 << 32))
    seed = int(gen.integers(0, 1 << 62))
    kw = dict(seed=seed, rng_mode=mode, greedy=temp <= 0,
              full_table=field != 0)
    want = _jax_step(kind, black, white, thr, row0, step, block_rows, **kw)
    b, w = _t(black), _t(white)
    got = packed.packed_fused_step_reference(b, w, thr, row0, step, **kw)
    for fn in FUSED:
        assert all(torch.equal(x, y) for x, y in
                   zip(fn(b, w, thr, row0, step, **kw), got))
    for g, wnt, before in zip(got, want, (black, white)):
        np.testing.assert_array_equal(_np(g), wnt)
        assert (wnt != before).any()
    # the inputs are not modified
    assert (_np(b) == black).all() and (_np(w) == white).all()


def test_cases_cover_the_modes_and_accepts():
    for kind in ("fused", "manual"):
        got = [c for c in CASES if c[0] == kind]
        assert {c[3] for c in got} >= {"philox", "threefry13", "chacha8",
                                       "hw"} - ({"threefry13"} if kind ==
                                                "manual" else set())
        assert {(c[4] > 0, c[5] != 0) for c in got} >= {
            (True, False), (False, False), (True, True)}
        assert any(c[1][1] // 16 % 2 for c in got)
        assert not any(c[5] for c in got if c[3] == "hw")


def _backends(nrows, geometry):
    kw = dict(backend="packed", nrows=nrows, ncols=64, rng="philox",
              **geometry)
    return (jpacked.PackedBackend(JaxConfig(**kw)),
            packed.PackedBackend(SimConfig(device="cpu", **kw)))


GEOMETRIES = {"ordered": {}, "J": dict(j_prob=0.1),
              "replicas": dict(xsl=8, ysl=8)}


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("nrows", [24, 48, 768])
@pytest.mark.parametrize("block_rows", [None, "8", "12"])
@pytest.mark.parametrize("fused", [None, "0", "1", "2"])
def test_fusable_matches_jax(fused, block_rows, nrows, geometry,
                             monkeypatch):
    """Both packages take the same path for the same flags and
    environment: the variable, the block height (its default and
    ISING_TPU_FUSED_BY), the row count, -J and replicas."""
    for name, value in (("ISING_TPU_FUSED", fused),
                        ("ISING_TPU_FUSED_BY", block_rows)):
        if value is not None:
            monkeypatch.setenv(name, value)
    jbe, tbe = _backends(nrows, GEOMETRIES[geometry])
    assert tbe.fusable(nrows) == jbe.fusable(nrows)
    if fused in ("1", "2") and geometry == "ordered":
        assert tbe.fused_block_rows(nrows) == jbe.fused_block_rows(nrows)


def test_update_step_needs_three_blocks_like_jax(monkeypatch):
    """Under =1 the JAX step takes its own block height whatever
    ISING_TPU_FUSED_BY says: fusable by the variable's height, and then
    refused for fewer than 3 of its own blocks, in both packages."""
    monkeypatch.setenv("ISING_TPU_FUSED", "1")
    monkeypatch.setenv("ISING_TPU_FUSED_BY", "8")
    jbe, tbe = _backends(64, {})
    assert jbe.fusable(64) and tbe.fusable(64)
    thr = ising.threshold_table(1.5)
    w = np.zeros((64, 4), np.uint32)
    with pytest.raises(ValueError, match="at least 3 row blocks"):
        jbe.update_step(jnp.asarray(w), jnp.asarray(w),
                        thr10=jnp.asarray(thr), step=jnp.uint32(0))
    with pytest.raises(ValueError, match="at least 3 row blocks"):
        tbe.update_step(_t(w), _t(w), thr10=thr, step=0)


# (nrows, block rows) where the JAX manual kernel goes wrong: 16 does not
# divide 56 (rows 48-55 are never written), 7 is odd (row parity is read
# per block).
BAD_BLOCK_ROWS = [(56, 16), (42, 7)]


@pytest.mark.parametrize("nrows,block_rows", BAD_BLOCK_ROWS)
def test_jax_manual_step_is_wrong_at_these_block_rows(nrows, block_rows,
                                                      monkeypatch):
    """The JAX fault the port refuses: its fusable takes these heights,
    and its manual fused step then differs from its own two-call path,
    which the port's plain step equals."""
    monkeypatch.setenv("ISING_TPU_FUSED", "2")
    monkeypatch.setenv("ISING_TPU_FUSED_BY", str(block_rows))
    jbe, _ = _backends(nrows, {})
    assert jbe.fusable(nrows)
    gen = np.random.default_rng(nrows)
    black, white = (_words(gen, (nrows, 4)) for _ in range(2))
    thr = ising.threshold_table(1.5)
    kw = dict(seed=3, rng_mode="threefry13", greedy=False, full_table=False)
    fused = _jax_step("manual", black, white, thr, 0, 5, block_rows, **kw)
    two = _jax_two_calls(black, white, thr, 0, 5, **kw)
    assert any((f != t).any() for f, t in zip(fused, two))
    port = packed.packed_fused_step_reference(_t(black), _t(white), thr, 0,
                                              5, **kw)
    for p, t in zip(port, two):
        np.testing.assert_array_equal(_np(p), t)


@pytest.mark.parametrize("nrows,block_rows", BAD_BLOCK_ROWS + [(48, 0)])
def test_port_refuses_those_block_rows(nrows, block_rows, monkeypatch,
                                       capsys):
    """Under =2 the port refuses a block height that is odd or does not
    divide nrows, naming the variable: the backend, Simulation and the CLI
    (exit 1). Under =1 the JAX step ignores the height, and so does the
    port; with -J the step is not fused, and nothing is refused."""
    monkeypatch.setenv("ISING_TPU_FUSED", "2")
    monkeypatch.setenv("ISING_TPU_FUSED_BY", str(block_rows))
    _, tbe = _backends(nrows, {})
    with pytest.raises(ValueError, match="ISING_TPU_FUSED_BY"):
        tbe.fusable(nrows)
    with pytest.raises(ValueError, match="ISING_TPU_FUSED_BY"):
        Simulation(SimConfig(backend="packed", nrows=nrows, ncols=64,
                             device="cpu"))
    assert cli.main(["--backend", "packed", "-x", "64", "-y", str(nrows),
                     "-n", "1", "--device", "cpu"]) == 1
    assert "ISING_TPU_FUSED_BY" in capsys.readouterr().err
    assert not _backends(nrows, dict(j_prob=0.1))[1].fusable(nrows)
    if block_rows:
        monkeypatch.setenv("ISING_TPU_FUSED", "1")
        jbe, tbe = _backends(nrows, {})
        assert tbe.fusable(nrows) == jbe.fusable(nrows)


class _Spy:
    """Counts PackedBackend.update_step and packed_sweep calls."""

    def __init__(self, monkeypatch):
        self.steps = self.sweeps = 0
        step, sweep = packed.PackedBackend.update_step, packed.packed_sweep

        def update_step(be, *a, **k):
            self.steps += 1
            return step(be, *a, **k)

        def packed_sweep(*a, **k):
            self.sweeps += 1
            return sweep(*a, **k)

        monkeypatch.setattr(packed.PackedBackend, "update_step", update_step)
        monkeypatch.setattr(packed, "packed_sweep", packed_sweep)


# (variable, block rows, config): =1 at the JAX step's own 256-row blocks,
# =2 at 8-row blocks, with the greedy quench and the field.
SIM_CASES = [
    ("1", None, dict(nrows=768, ncols=64, temp=1.5, seed=11, rng="philox")),
    ("2", "8", dict(nrows=24, ncols=64, temp=0.0, seed=12, rng="threefry13")),
    ("2", "8", dict(nrows=40, ncols=128, temp=1.4, seed=13, rng="chacha8",
                    field=0.2)),
]


@pytest.mark.parametrize("fused,block_rows,kw", SIM_CASES)
def test_simulation_matches_jax_and_two_calls(fused, block_rows, kw,
                                              monkeypatch):
    """Simulation under the variable takes one fused step a step, and its
    words, measure() and energy equal the JAX package's under the same
    variable and those of the port's two-call path (built without it)."""
    two = Simulation(SimConfig(backend="packed", device="cpu", **kw))
    monkeypatch.setenv("ISING_TPU_FUSED", fused)
    if block_rows:
        monkeypatch.setenv("ISING_TPU_FUSED_BY", block_rows)
    jsim = JaxSimulation(JaxConfig(backend="packed", **kw))
    tsim = Simulation(SimConfig(backend="packed", device="cpu", **kw))
    spy = _Spy(monkeypatch)
    for _ in range(2):
        jsim.advance(2)
        tsim.advance(2)
        assert (spy.steps, spy.sweeps) == (2, 0)
        two.advance(2)
        assert (spy.steps, spy.sweeps) == (2, 4)
        spy.steps = spy.sweeps = 0
        for a, b, c in zip((tsim.black, tsim.white), (two.black, two.white),
                           (jsim.black, jsim.white)):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(c))
        assert tsim.measure() == two.measure() == jsim.measure()
        assert tsim.energy_total() == jsim.energy_total()


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("fused,block_rows,argv", [
    ("1", None, ["-y", "768", "--rng", "philox"]),
    ("2", "8", ["-y", "24", "-t", "0"]),
])
def test_cli_lines_match_jax(fused, block_rows, argv, capsys, monkeypatch):
    """Under the variable the port's CLI prints the JAX CLI's magnetization
    lines, and those of its own two-call path."""
    from ising_tpu import cli as jcli
    argv = ["--backend", "packed", "-x", "64", "-n", "4", "-p", "2"] + argv
    assert cli.main(argv + ["--device", "cpu"]) == 0
    two = _mag_lines(capsys.readouterr().out)
    monkeypatch.setenv("ISING_TPU_FUSED", fused)
    if block_rows:
        monkeypatch.setenv("ISING_TPU_FUSED_BY", block_rows)
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    spy = _Spy(monkeypatch)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert (spy.steps, spy.sweeps) == (4, 0)
    assert _mag_lines(capsys.readouterr().out) == want == two
    assert len(want) == 4


class _CudaWords:
    """A word plane that the wrappers take for a CUDA tensor (no card
    here); torch.empty_like of one is another, on its own buffer."""

    def __init__(self, buf, offset, shape, device="cuda", dtype=torch.int32):
        self.buf, self.offset, self.shape = buf, offset, tuple(shape)
        self.device, self.dtype = torch.device(device, 0), dtype

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.empty_like:
            t = args[0]
            return cls(np.zeros(t.shape[0] * t.shape[1], np.uint32), 0,
                       t.shape)
        return NotImplemented

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.buf.ctypes.data + 4 * self.offset

    def numel(self):
        return self.shape[0] * self.shape[1]

    def element_size(self):
        return 4


class _FakeLib:
    """Records the fused entry points' arguments; returns `code`."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def packed_fused_step_launch(self, *args):
        self.calls.append(("packed_fused_step", args))
        return self.code

    def packed_fused_step_manual_launch(self, *args):
        self.calls.append(("packed_fused_step_manual", args))
        return self.code

    def ising_cuda_error_string(self, code):
        return b"fake error"


def _fake_card(monkeypatch, code=0):
    monkeypatch.setattr(packed, "packed_fused_step_reference", lambda *a, **k:
                        pytest.fail("plain version called on a CUDA tensor"))
    monkeypatch.setattr(packed, "_cuda_stream", lambda device: 1234)
    lib = _FakeLib(code)
    monkeypatch.setattr(packed.kernel_lib, "load", lambda: (lib, None))
    return lib


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
@pytest.mark.parametrize("mode,family,rounds,tag", [
    ("philox", 0, 10, 0), ("threefry13", 1, 13, 0), ("chacha6", 2, 6, 0),
    ("hw", 0, 10, 0x8000)])
@pytest.mark.parametrize("temp,field,accept", [(1.5, 0.0, 0), (0.0, 0.0, 1),
                                               (0.0, 0.3, 2)])
def test_wrapper_launches_kernel_on_cuda_tensor(fn, mode, family, rounds, tag,
                                                temp, field, accept,
                                                monkeypatch):
    """On a CUDA tensor each wrapper launches its own entry point (never
    the plain version) with new output planes, both colors' tags and keys
    (hw as salted Philox-10, Threefry's stream key per color), the accept
    variant, the thresholds and the band; then counts the launch."""
    lib = _fake_card(monkeypatch)
    buf = np.zeros(64, np.uint32)
    black, white = _CudaWords(buf, 0, (8, 4)), _CudaWords(buf, 32, (8, 4))
    thr = ising.threshold_table(temp, field)
    before = [f.launches for f in FUSED]
    nb, nw = fn(black, white, thr, 6, 9, seed=5, rng_mode=mode,
                greedy=temp <= 0, full_table=field != 0, band_rows=3)
    assert [f.launches for f in FUSED] == [
        b + (f is fn) for b, f in zip(before, FUSED)]
    ((name, args),) = lib.calls
    assert name == fn.__name__
    assert args[:4] == (black.data_ptr(), white.data_ptr(), nb.data_ptr(),
                        nw.data_ptr())
    assert not {nb.data_ptr(), nw.data_ptr()} & {black.data_ptr(),
                                                 white.data_ptr()}
    assert args[4:8] == (8, 4, 6, 9)
    assert list(args[8]) == [int(t) for t in thr]
    for color, (t, k0, k1) in ((0, args[9:12]), (1, args[12:15])):
        assert t == tag | color
        assert (k0, k1) == (threefry_stream_key(5, 9, t) if family == 1
                            else (5, 0))
    assert args[15:] == (family, rounds, accept, 3, 1234)


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
@pytest.mark.parametrize("bad,msg", [
    (dict(white=((8, 5), "cuda", torch.int32)), "white has shape"),
    (dict(white=((8, 4), "cuda", torch.int64)), "torch.int32"),
    (dict(white=((8, 4), "cpu", torch.int32)), "white is on cpu"),
    (dict(overlap=True), "must not overlap"),
    (dict(rng_mode="philox7b"), "bit-plane mode"),
    (dict(rng_mode="chacha8", shape=(8, 3)), "even W"),
    (dict(band_rows=0), "band_rows must be positive"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fn, bad, msg,
                                                       monkeypatch):
    """Shapes, dtypes, devices, black/white overlap (the two-call path
    updates black in place before white reads it), modes, ChaCha's even W
    and the band: refused before the kernel library is loaded."""
    monkeypatch.setattr(packed.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    bad = dict(bad)
    H, W = bad.pop("shape", (8, 4))
    buf = np.zeros(256, np.uint32)
    black = _CudaWords(buf, 0, (H, W))
    white = _CudaWords(buf, 8 if bad.pop("overlap", False) else 128, (H, W))
    if "white" in bad:
        shape, device, dtype = bad.pop("white")
        white = _CudaWords(buf, 128, shape, device, dtype)
    kw = dict(seed=1, rng_mode="philox") | bad
    with pytest.raises((ValueError, TypeError), match=msg):
        fn(black, white, ising.threshold_table(1.5), 0, 0, **kw)


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
def test_wrapper_refuses_other_devices(fn):
    t = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
        fn(t, t.clone(), ising.threshold_table(1.5), 0, 0, seed=1,
           rng_mode="philox")


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
def test_wrapper_raises_on_failed_launch(fn, monkeypatch):
    _fake_card(monkeypatch, code=700)
    buf = np.zeros(64, np.uint32)
    black, white = _CudaWords(buf, 0, (4, 4)), _CudaWords(buf, 16, (4, 4))
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fn(black, white, ising.threshold_table(1.0), 0, 0, seed=1,
           rng_mode="philox")
    assert fn.launches == before


@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
def test_wrapper_runs_the_plain_version_on_cpu(fn):
    gen = np.random.default_rng(6)
    black, white = (_words(gen, (6, 4)) for _ in range(2))
    thr = ising.threshold_table(1.5)
    kw = dict(seed=5, rng_mode="threefry", greedy=False)
    want = packed.packed_fused_step_reference(_t(black), _t(white), thr, 1,
                                              3, **kw)
    before = fn.launches
    got = fn(_t(black), _t(white), thr, 1, 3, band_rows=2, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fn.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fn", FUSED, ids=lambda f: f.__name__)
@pytest.mark.parametrize("mode", ["philox", "threefry13", "chacha8", "hw"])
def test_kernel_matches_plain_on_card(fn, mode, cuda_device):
    """csrc/packed_fused.cu against its plain version on the card: H = 2,
    6 and 14 (bands wrapping onto themselves), W = 66, bands of 1 and 3
    rows and the default, every accept."""
    gen = np.random.default_rng(19)
    accepts = [(1.5, 0.0), (0.0, 0.0)] + ([] if mode == "hw" else
                                          [(1.5, 0.3)])
    for H in (2, 6, 14):
        for temp, field in accepts:
            b, w = (_t(_words(gen, (H, 66))).to(cuda_device)
                    for _ in range(2))
            thr = ising.threshold_table(temp, field)
            kw = dict(seed=7, rng_mode=mode, greedy=temp <= 0,
                      full_table=field != 0)
            want = packed.packed_fused_step_reference(b, w, thr, 2, 1, **kw)
            for band in (None, 1, 3):
                got = fn(b, w, thr, 2, 1, band_rows=band, **kw)
                torch.cuda.synchronize()
                assert all(torch.equal(g, x) for g, x in zip(got, want))
