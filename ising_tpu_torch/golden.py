"""Reference trajectories of the JAX package, for checking the port.

Each case, keyed (rng mode, temperature) or (rng mode, temperature,
field), runs a 64 x 16384 lattice (the full bench width, 32 rows of words
per color) from seed SEED_DEF for NSTEPS steps. ``up`` holds the up-spin
count before the first step and after each step; ``crc32`` is zlib.crc32
of the final black then white bit1 words (uint32, little-endian).

The counter-mode values come from the JAX package's xla backend. The hw
values come from its bit1 backend with the Pallas kernel in interpret
mode, where the kernel draws hw as salted Philox-10, the stream the
port's hw is; on a TPU the hardware generator gives other values, which
nothing here records. tests/test_torch_golden.py derives every case again
and checks it is equal, and chip_smoke.py checks the port's CUDA kernels
reproduce them on the card.
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
}


def words_crc32(black_u32, white_u32) -> int:
    """CRC32 of the black then white uint32 word planes (little-endian)."""
    crc = zlib.crc32(np.asarray(black_u32, "<u4").tobytes())
    return zlib.crc32(np.asarray(white_u32, "<u4").tobytes(), crc)


def port_trajectory(rng: str, temp: float, field: float = 0.0, *,
                    device="cuda", backend: str = "bit1") -> dict:
    """The port's {"up", "crc32"} for one golden case, on `device`."""
    from .config import SimConfig
    from .driver import Simulation
    from .interop import to_numpy_words
    from .ops.bit1 import pack_bits1
    sim = Simulation(SimConfig(nrows=NROWS, ncols=NCOLS, temp=temp,
                               field=field, seed=SEED, backend=backend,
                               rng=rng, device=str(device)))
    ups = [sim.measure()["up"]]
    for _ in range(NSTEPS):
        sim.advance(1)
        ups.append(sim.measure()["up"])
    words = (pack_bits1(p) for p in sim.bits())
    return {"up": tuple(ups), "crc32": words_crc32(*to_numpy_words(*words))}
