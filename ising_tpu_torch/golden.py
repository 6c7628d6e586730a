"""Reference trajectories of the JAX package, for checking the port.

Each case, keyed (rng mode, temperature), (rng mode, temperature, field)
or, with quenched disorder or replicas, (rng mode, temperature, field,
j_prob, xsl, ysl), runs a 64 x 16384 lattice (the full bench width, 32
rows of words per color) from seed SEED_DEF for NSTEPS steps. A seventh
entry names the backend whose trajectory it is: hw draws differ by
backend (bit1 takes 24 bit planes per word, packed and dense one u32 per
spin), and the counter modes do not, so ``backends(case)`` lists every
backend of the port that runs a case. ``up``
holds the up-spin count before the first step and after each step;
``crc32`` is zlib.crc32 of the final black then white bit1 words (uint32,
little-endian); a disordered case also holds the final ``energy_total``.

The counter-mode values come from the JAX package's xla backend. The hw
values come from its bit1 and packed backends with the Pallas kernels in
interpret mode (its dense backend gives packed's hw case too), where the
kernels draw hw as salted Philox-10, the stream the port's hw is; on a TPU
the hardware generator gives other values, which nothing here records.
SW_GOLDEN holds Swendsen-Wang trajectories (--algo sw), keyed (temperature,
field, xsl, ysl): a 256 x 1024 lattice from seed SEED_DEF at T = Tc, with
h = 0.1, and in 64 x 64 replicas, NSTEPS updates each, recorded from the
JAX package's SwendsenWang on the CPU, with the same "up" and "crc32".
IO_GOLDEN holds the output files (-c, -o, --checkpoint), keyed (backend,
rng mode, nrows, ncols): from seed SEED_DEF at T = 1.5 after IO_NSTEPS
steps, the zlib.crc32 of the -c line written for that iteration, of the
hex dump and of the checkpoint (io_crcs), as the JAX package writes them
for that backend (bit1's from its words, packed's through its decode).
PT_GOLDEN holds one parallel-tempering run (--pt): a PT_NROWS x PT_NCOLS
lattice with -J PT_J_PROB, the ladder PT_TEMPS, PT_SWEEPS sweeps a swap,
PT_ROUNDS rounds, recorded from the JAX package's ParallelTempering on
its xla backend (pt_record); a counter-mode run, so every backend of the
port gives it.

tests/test_torch_golden.py (tests/test_torch_io.py for IO_GOLDEN) derives
every case again and checks it is equal, and chip_smoke.py checks the
port's CUDA kernels reproduce them on the card.
"""

from __future__ import annotations

import contextlib
import zlib
from pathlib import Path

import numpy as np

from .constants import SEED_DEF, TCRIT
from .rng import plane_bits

NROWS, NCOLS, NSTEPS = 64, 16384, 4
SEED = SEED_DEF

GOLDEN = {
    ("threefry13", 1.5): {"up": (524222, 524868, 526856, 528483, 529617),
                          "crc32": 0xDEFE3161},
    ("threefry13", 0.0): {"up": (524222, 524221, 523852, 523252, 522749),
                          "crc32": 0x92875F0E},
    ("philox", 1.5): {"up": (524222, 524394, 524719, 524367, 523665),
                      "crc32": 0x45235BE2},
    ("philox", 0.0): {"up": (524222, 523152, 522549, 522622, 522540),
                      "crc32": 0xEB696C31},
    ("chacha8", 1.5): {"up": (524222, 524475, 525368, 525416, 525590),
                       "crc32": 0xCE9504B2},
    ("chacha8b", 1.5): {"up": (524222, 524156, 524893, 524925, 524323),
                        "crc32": 0xC60816F3},
    ("chacha6b", 1.5): {"up": (524222, 524937, 526202, 527072, 528603),
                        "crc32": 0x42FFFCAD},
    ("chacha4b", 1.5): {"up": (524222, 524206, 524295, 524071, 523953),
                        "crc32": 0x38DAB4C7},
    ("philox7b", 1.5): {"up": (524222, 524164, 524869, 525029, 525256),
                        "crc32": 0x444CC46D},
    ("threefry13b", 1.5): {"up": (524222, 524153, 524317, 524436, 524252),
                           "crc32": 0xDFB45081},
    ("chacha6b", 0.0): {"up": (524222, 523287, 523362, 523119, 523882),
                        "crc32": 0x880E8869},
    ("hw", 1.5): {"up": (524222, 524606, 525668, 527050, 528215),
                  "crc32": 0xB8A39E5B},
    ("chacha8b", 1.5, 0.1): {"up": (524222, 567882, 637263, 702143, 760234),
                             "crc32": 0x3F6E5930},
    # -J 0.1: split links on bit1
    ("threefry13", 1.5, 0.0, 0.1, None, None): {
        "up": (524222, 524501, 525615, 525171, 524361), "crc32": 0x947586B9,
        "energy_total": 1328284},
    ("chacha6b", 1.5, 0.0, 0.1, None, None): {
        "up": (524222, 524504, 525434, 525226, 524438), "crc32": 0x13F9ED85,
        "energy_total": 1330336},
    ("philox", 0.0, 0.0, 0.5, None, None): {
        "up": (524222, 523790, 523736, 523969, 524062), "crc32": 0xD1DB8AB9,
        "energy_total": 1272628},
    # --xsl 128 --ysl 8: csl = 64 divides W1 = 256
    ("chacha6b", 1.5, 0.0, None, 128, 8): {
        "up": (524222, 524494, 526157, 526802, 526540), "crc32": 0xD9368040},
    # replicas with disorder: per-color J planes
    ("threefry13", 1.5, 0.0, 0.1, 128, 16): {
        "up": (524222, 524325, 525344, 524737, 524175), "crc32": 0x3C6B8C9F,
        "energy_total": 1271200},
    ("philox7b", 1.5, 0.1, 0.1, None, None): {
        "up": (524222, 565253, 619138, 660247, 693394), "crc32": 0x55E4C9CE,
        "energy_total": 1351636},
    # hw on packed: one salted Philox-10 u32 per spin
    ("hw", 1.5, 0.0, None, None, None, "packed"): {
        "up": (524222, 524756, 525118, 525515, 525659), "crc32": 0x6C525E38},
    # the u32 full table of the field (xla and packed)
    ("philox", 1.5, 0.1): {"up": (524222, 568384, 637189, 701654, 759599),
                           "crc32": 0xBC2F721D},
    # --xsl 128 --ysl 8 in a u32 ChaCha mode
    ("chacha8", 1.5, 0.0, None, 128, 8): {
        "up": (524222, 523937, 524995, 525428, 525480), "crc32": 0x2D7467B0},
}

SW_NROWS, SW_NCOLS = 256, 1024

SW_GOLDEN = {
    (TCRIT, 0.0, None, None): {
        "up": (130911, 129738, 131668, 132010, 132099), "crc32": 0x9C7F9F24},
    (TCRIT, 0.1, None, None): {
        "up": (130911, 150699, 177161, 199651, 214852), "crc32": 0xFC693F40},
    (TCRIT, 0.0, 64, 64): {
        "up": (130911, 130574, 130160, 128070, 127755), "crc32": 0x6E54B1D6},
}

IO_NSTEPS = 4

IO_GOLDEN = {
    ("bit1", "threefry13", 64, 512): {
        "corr": 0x0D0FBA72, "dump": 0xB247FB23, "checkpoint": 0x208751C3},
    ("packed", "chacha8", 64, 512): {
        "corr": 0xA6550C67, "dump": 0xE318A99C, "checkpoint": 0xC389C0F7},
}

# Parallel tempering: two ladders over one -J 0.4 realization (j_seed
# SEED), the second from seed SEED + 1.
PT_NROWS = PT_NCOLS = 64
PT_J_PROB = 0.4
PT_TEMPS = (1.9, 2.0, 2.1)
PT_SWEEPS, PT_ROUNDS = 2, 6

PT_GOLDEN = {
    "accepts": (1, 0), "attempts": (3, 3), "replica_at": (1, 0, 2),
    "H": (-3872, -3716, -3504), "up": (2094, 2043, 2079),
    "crc32": (0xCDFBB3AC, 0x07389111, 0x656E3BE5),
    "overlap": (-0.0341796875, 0.01220703125, 0.02490234375),
}

BACKENDS = ("bit1", "xla", "packed", "dense")


def backends(case) -> tuple:
    """The port's backends that run `case`: those whose config takes its
    mode, field and replicas. bit1 takes a field only in the bit-plane
    modes and hw, packed and dense draw u32 only, dense has no replicas,
    and xla's hw stream has no counter contract. A case that names packed
    (hw drawn as one salted Philox-10 u32 per spin) is dense's hw stream
    too. mxu runs none: 64 rows are under its 128-row fence."""
    if len(case) == 7:
        # dense shares packed's per-site u32 stream, not its replicas
        dense = case[6] == "packed" and case[4] is None
        return (case[6], "dense") if dense else (case[6],)
    rng, field = case[0], case[2] if len(case) > 2 else 0.0
    replicas = len(case) > 4 and case[4] is not None
    planes = plane_bits(rng) > 0
    out = []
    if planes or rng == "hw" or not field:
        out.append("bit1")
    if rng != "hw":
        out.append("xla")
    if not planes and rng != "hw":
        out.append("packed")
        if not replicas:
            out.append("dense")
    return tuple(out)


def words_crc32(black_u32, white_u32) -> int:
    """CRC32 of the black then white uint32 word planes (little-endian)."""
    crc = zlib.crc32(np.asarray(black_u32, "<u4").tobytes())
    return zlib.crc32(np.asarray(white_u32, "<u4").tobytes(), crc)


def port_trajectory(rng: str, temp: float, field: float = 0.0,
                    j_prob: float | None = None, xsl: int | None = None,
                    ysl: int | None = None, backend: str = "bit1", *,
                    device="cuda") -> dict:
    """The port's {"up", "crc32"[, "energy_total"]} for one golden case,
    on `device` (port_trajectory(*case) runs a case's named backend)."""
    from .config import SimConfig
    from .driver import Simulation
    sim = Simulation(SimConfig(nrows=NROWS, ncols=NCOLS, temp=temp,
                               field=field, seed=SEED, backend=backend,
                               rng=rng, j_prob=j_prob, xsl=xsl, ysl=ysl,
                               device=str(device)))
    out = _trajectory(sim)
    if j_prob is not None:
        out["energy_total"] = sim.energy_total()
    return out


def _trajectory(sim) -> dict:
    """{"up", "crc32"} of NSTEPS steps of sim (Simulation or
    SwendsenWang)."""
    from .interop import to_numpy_words
    from .ops.bit1 import pack_bits1
    ups = [sim.measure()["up"]]
    for _ in range(NSTEPS):
        sim.advance(1)
        ups.append(sim.measure()["up"])
    words = (pack_bits1(p) for p in sim.bits())
    return {"up": tuple(ups), "crc32": words_crc32(*to_numpy_words(*words))}


def port_sw_trajectory(temp: float, field: float = 0.0,
                       xsl: int | None = None, ysl: int | None = None, *,
                       device="cuda") -> dict:
    """The port's {"up", "crc32"} for one SW_GOLDEN case on `device`."""
    from .cluster import SwendsenWang
    from .config import SimConfig
    return _trajectory(SwendsenWang(SimConfig(
        nrows=SW_NROWS, ncols=SW_NCOLS, temp=temp, field=field, xsl=xsl,
        ysl=ysl, seed=SEED, device=str(device))))


def io_config(case) -> dict:
    """SimConfig keywords of an IO_GOLDEN case (the same in both
    packages)."""
    backend, rng, nrows, ncols = case
    return dict(nrows=nrows, ncols=ncols, temp=1.5, seed=SEED,
                backend=backend, rng=rng)


def io_crcs(sim, directory) -> dict:
    """Write the three files of IO_GOLDEN from sim's current state into
    `directory`, which holds none of them yet (the -c line of iteration IO_NSTEPS, the hex dump, the
    checkpoint) and return their crc32. sim is a Simulation of either
    package: both name these methods alike."""
    with contextlib.chdir(directory):
        sim._append_corr(IO_NSTEPS)
        sim.dump("lattice.txt")
        sim.checkpoint("state.ck")
        files = {"corr": sim._corr_path(), "dump": "lattice.txt",
                 "checkpoint": "state.ck"}
        return {k: zlib.crc32(Path(p).read_bytes()) for k, p in files.items()}


def port_io_files(case, directory, *, device="cuda") -> dict:
    """io_crcs of the port's Simulation after IO_NSTEPS steps of an
    IO_GOLDEN case on `device`."""
    from .config import SimConfig
    from .driver import Simulation
    sim = Simulation(SimConfig(**io_config(case), device=str(device)))
    sim.advance(IO_NSTEPS)
    return io_crcs(sim, directory)


def pt_config(seed: int) -> dict:
    """SimConfig keywords of a PT_GOLDEN ladder (the same in both
    packages; each rung replaces temp and seed)."""
    return dict(nrows=PT_NROWS, ncols=PT_NCOLS, temp=PT_TEMPS[0], seed=seed,
                j_prob=PT_J_PROB, j_seed=SEED)


def pt_record(pt_a, pt_b, words, replica_overlap) -> dict:
    """Advance two ladders PT_ROUNDS rounds and return PT_GOLDEN's record
    of the first: its swap counts, rung -> replica map, each rung's final
    Hamiltonian and up count, the crc32 of each rung's final bit1 words
    (words(sim) -> (black, white) uint32 numpy) and the overlaps with the
    second. Either package's ParallelTempering, with its replica_overlap."""
    for _ in range(PT_ROUNDS):
        pt_a.advance_round()
        pt_b.advance_round()
    m = pt_a.measure()
    return {"accepts": tuple(pt_a.accepts),
            "attempts": tuple(pt_a.attempts),
            "replica_at": tuple(pt_a.replica_at),
            "H": tuple(r["hamiltonian"] for r in m),
            "up": tuple(r["up"] for r in m),
            "crc32": tuple(words_crc32(*words(s)) for s in pt_a.sims),
            "overlap": tuple(replica_overlap(pt_a, pt_b))}


def port_pt_record(backend: str, *, device="cuda") -> dict:
    """pt_record of the port's two PT_GOLDEN ladders on `backend` and
    `device`."""
    from .config import SimConfig
    from .interop import to_numpy_words
    from .ops.bit1 import pack_bits1
    from .tempering import ParallelTempering, replica_overlap
    pts = [ParallelTempering(
        SimConfig(**pt_config(seed), backend=backend, device=str(device)),
        PT_TEMPS, sweeps_per_swap=PT_SWEEPS) for seed in (SEED, SEED + 1)]
    return pt_record(*pts, lambda s: to_numpy_words(
        *(pack_bits1(p) for p in s.bits())), replica_overlap)
