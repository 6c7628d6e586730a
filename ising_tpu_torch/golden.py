"""Reference trajectories of the JAX package, for checking the port.

Each case runs a 64 x 16384 lattice (the full bench width, 32 rows of
words per color) from seed SEED_DEF for NSTEPS steps. ``up`` holds the
up-spin count before the first step and after each step; ``crc32`` is
zlib.crc32 of the final black then white bit1 words (uint32,
little-endian). The values come from the JAX package's xla backend;
tests/test_torch_golden.py derives them again and checks they are equal,
and chip_smoke.py checks the port's CUDA kernel reproduces them on the card.
"""

from __future__ import annotations

import zlib

import numpy as np

from .constants import SEED_DEF

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
}


def words_crc32(black_u32, white_u32) -> int:
    """CRC32 of the black then white uint32 word planes (little-endian)."""
    crc = zlib.crc32(np.asarray(black_u32, "<u4").tobytes())
    return zlib.crc32(np.asarray(white_u32, "<u4").tobytes(), crc)


def port_trajectory(rng: str, temp: float, device="cuda") -> dict:
    """The port's {"up", "crc32"} for one golden case, on `device`."""
    from .config import SimConfig
    from .driver import Simulation
    from .interop import to_numpy_words
    sim = Simulation(SimConfig(nrows=NROWS, ncols=NCOLS, temp=temp,
                               seed=SEED, backend="bit1", rng=rng,
                               device=str(device)))
    ups = [sim.measure()["up"]]
    for _ in range(NSTEPS):
        sim.advance(1)
        ups.append(sim.measure()["up"])
    return {"up": tuple(ups),
            "crc32": words_crc32(*to_numpy_words(sim.black, sim.white))}
