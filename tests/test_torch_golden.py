"""The reference trajectories in ising_tpu_torch/golden.py, derived again
from the JAX package, and reproduced by the port on the CPU with each of
its backends that runs a case (golden.backends). chip_smoke.py checks the
same constants against the CUDA kernels.

The JAX package's xla backend derives the u32 counter-mode cases. Its
bit1 backend, with the Pallas kernel in interpret mode, derives hw (the
off-TPU hw stream) and the bit-plane cases (its xla backend computes the
same bit-plane trajectories, checked once below, but takes up to a minute
to compile one of them on the CPU); its packed backend, also in interpret
mode, derives the case that names packed (hw drawn per spin), and its dense
backend every case that dense runs.
"""

import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import golden
from ising_tpu_torch.rng import plane_bits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once, and torch's intra-op threads
    on top of them slowed this file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(bits):
    """(Y, C) uint8 bit plane -> (Y, C/32) uint32 bit1 words (bit g of word
    j = compact column g*W1 + j), in numpy."""
    Y, C = bits.shape
    g = bits.reshape(Y, 32, C // 32).astype(np.uint64)
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (g * weights[None, :, None]).sum(axis=1).astype(np.uint32)


def _jax_trajectory(rng, temp, field=0.0, j_prob=None, xsl=None, ysl=None,
                    backend=None):
    if backend is None:
        backend = "bit1" if rng == "hw" or plane_bits(rng) else "xla"
    sim = JaxSimulation(JaxConfig(nrows=golden.NROWS, ncols=golden.NCOLS,
                                  temp=temp, field=field, seed=golden.SEED,
                                  backend=backend, rng=rng, j_prob=j_prob,
                                  xsl=xsl, ysl=ysl))
    ups = [sim.measure()["up"]]
    for _ in range(golden.NSTEPS):
        sim.advance(1)
        ups.append(sim.measure()["up"])
    b, w = (_words(np.asarray(x)) for x in sim.bits())
    out = {"up": tuple(ups), "crc32": golden.words_crc32(b, w)}
    if j_prob is not None:
        out["energy_total"] = sim.energy_total()
    return out


@pytest.mark.parametrize("case", list(golden.GOLDEN))
def test_golden_constants_come_from_jax(case):
    assert _jax_trajectory(*case) == golden.GOLDEN[case]


def test_plane_golden_is_jax_xla_trajectory():
    assert _jax_trajectory("chacha4b", 1.5, backend="xla") == \
        golden.GOLDEN[("chacha4b", 1.5)]


def _cases_of(backend):
    return [c for c in golden.GOLDEN if backend in golden.backends(c)]


@pytest.mark.parametrize("case", _cases_of("bit1"))
def test_port_reproduces_golden_on_cpu(case):
    assert golden.port_trajectory(*case, device="cpu") == golden.GOLDEN[case]


@pytest.mark.parametrize("case", _cases_of("xla"))
def test_port_xla_reproduces_golden_on_cpu(case):
    assert golden.port_trajectory(*case, device="cpu", backend="xla") == \
        golden.GOLDEN[case]


@pytest.mark.parametrize("case", _cases_of("packed"))
def test_port_packed_reproduces_golden_on_cpu(case):
    assert golden.port_trajectory(*case[:6], device="cpu",
                                  backend="packed") == golden.GOLDEN[case]


@pytest.mark.parametrize("case", _cases_of("dense"))
def test_port_dense_reproduces_golden_on_cpu(case):
    assert golden.port_trajectory(*case[:6], device="cpu",
                                  backend="dense") == golden.GOLDEN[case]


@pytest.mark.parametrize("case", _cases_of("dense"))
def test_dense_golden_comes_from_jax_dense(case):
    """The JAX package's dense backend (its Pallas kernel in interpret
    mode) gives every case golden.backends lists for dense: the u32
    counter modes, the u32 field, -J, and packed's hw case."""
    assert _jax_trajectory(*case[:6], backend="dense") == golden.GOLDEN[case]


def test_golden_cases_cover_packed():
    """Every u32 counter case runs on packed too, and on dense where it has
    no replicas; hw has a packed case of its own (one salted Philox-10 u32
    per spin, not bit1's 24 planes), which dense draws too."""
    u32 = [c for c in golden.GOLDEN if c[0] != "hw" and not plane_bits(c[0])]
    assert len(u32) == 10 and all("packed" in golden.backends(c) for c in u32)
    assert [c for c in u32 if "dense" not in golden.backends(c)] == [
        c for c in u32 if len(c) > 4 and c[4] is not None]
    assert golden.backends(("hw", 1.5)) == ("bit1",)
    hw = ("hw", 1.5, 0.0, None, None, None, "packed")
    assert golden.backends(hw) == ("packed", "dense")
    assert golden.GOLDEN[hw] != golden.GOLDEN[("hw", 1.5)]
    assert golden.backends(("philox", 1.5, 0.1)) == ("xla", "packed",
                                                     "dense")
    assert len(_cases_of("dense")) == 9
    assert not _cases_of("mxu")


@pytest.mark.parametrize("case, want", [
    (("hw", 1.5, 0.0, None, None, None, "packed"), ("packed", "dense")),
    (("hw", 1.5, 0.0, None, None, None, "bit1"), ("bit1",)),
    (("threefry13", 1.5, 0.0, None, 128, None, "packed"), ("packed",)),
])
def test_backends_of_a_case_that_names_one(case, want):
    """A case that names its backend runs there, and on dense only where it
    is packed's per-site u32 stream without replicas."""
    assert golden.backends(case) == want


def test_golden_cases_cover_both_families_and_accepts():
    modes = {c[0] for c in golden.GOLDEN}
    assert {"threefry13", "philox", "chacha8", "chacha8b", "chacha6b",
            "chacha4b", "philox7b", "threefry13b", "hw"} == modes
    assert {c[1] <= 0 for c in golden.GOLDEN} == {True, False}
    assert {c[1] <= 0 for c in golden.GOLDEN if plane_bits(c[0])} == \
        {True, False}
    assert [c for c in golden.GOLDEN if len(c) == 3] == [
        ("chacha8b", 1.5, 0.1), ("philox", 1.5, 0.1)]
    assert golden.NCOLS == 16384  # the full bench width


def test_golden_cases_cover_disorder_and_replicas():
    """The disorder and replica cases: split links on bit1 (-J alone) in
    threefry13 and chacha6b at T = 1.5 and in philox at T = 0, replicas
    whose csl = 64 divides W1 = 256 (in a bit-plane and a u32 ChaCha
    mode), replicas with J planes, and a bit-plane mode with a field and
    J; each disordered case records its energy."""
    extra = {c: v for c, v in golden.GOLDEN.items() if len(c) == 6}
    assert set(extra) == {
        ("threefry13", 1.5, 0.0, 0.1, None, None),
        ("chacha6b", 1.5, 0.0, 0.1, None, None),
        ("philox", 0.0, 0.0, 0.5, None, None),
        ("chacha6b", 1.5, 0.0, None, 128, 8),
        ("threefry13", 1.5, 0.0, 0.1, 128, 16),
        ("philox7b", 1.5, 0.1, 0.1, None, None),
        ("chacha8", 1.5, 0.0, None, 128, 8)}
    for case, want in extra.items():
        assert ("energy_total" in want) == (case[3] is not None)
        if case[4] is not None:
            assert (golden.NCOLS // 64) % (case[4] // 2) == 0


def _jax_sw_trajectory(temp, field, xsl, ysl):
    from ising_tpu.cluster import SwendsenWang as JaxSwendsenWang
    sw = JaxSwendsenWang(JaxConfig(nrows=golden.SW_NROWS,
                                   ncols=golden.SW_NCOLS, temp=temp,
                                   field=field, xsl=xsl, ysl=ysl,
                                   seed=golden.SEED, backend="xla"))
    ups = [sw.measure()["up"]]
    for _ in range(golden.NSTEPS):
        sw.advance(1)
        ups.append(sw.measure()["up"])
    b, w = (_words(np.asarray(x)) for x in sw.bits())
    return {"up": tuple(ups), "crc32": golden.words_crc32(b, w)}


@pytest.mark.parametrize("case", list(golden.SW_GOLDEN))
def test_sw_golden_constants_come_from_jax(case):
    assert _jax_sw_trajectory(*case) == golden.SW_GOLDEN[case]


@pytest.mark.parametrize("case", list(golden.SW_GOLDEN))
def test_port_reproduces_sw_golden_on_cpu(case):
    assert golden.port_sw_trajectory(*case, device="cpu") == \
        golden.SW_GOLDEN[case]


def _jax_pt_record():
    from ising_tpu.tempering import ParallelTempering, replica_overlap
    pts = [ParallelTempering(JaxConfig(**golden.pt_config(seed),
                                       backend="xla"),
                             golden.PT_TEMPS,
                             sweeps_per_swap=golden.PT_SWEEPS)
           for seed in (golden.SEED, golden.SEED + 1)]
    return golden.pt_record(
        *pts, lambda s: tuple(_words(np.asarray(p)) for p in s.bits()),
        replica_overlap)


def test_pt_golden_comes_from_jax():
    """PT_GOLDEN is the JAX package's ParallelTempering on its xla backend,
    and the record holds a swap that was accepted."""
    assert _jax_pt_record() == golden.PT_GOLDEN
    assert sum(golden.PT_GOLDEN["accepts"]) > 0


@pytest.mark.parametrize("backend", ["xla", "bit1", "packed", "dense"])
def test_port_reproduces_pt_golden_on_cpu(backend):
    assert golden.port_pt_record(backend, device="cpu") == golden.PT_GOLDEN
