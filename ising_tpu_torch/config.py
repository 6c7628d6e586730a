"""Simulation config of the port: the JAX package's SimConfig, plus `device`.

Same fields, defaults and validation as ``ising_tpu/config.py``.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from .constants import ALPHA_DEF, SEED_DEF, TCRIT
from .rng import RNG_MODES, plane_bits

SPINS_PER_WORD = 8  # the packed tier's 4-bit fields (its ncols fence)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A CUDA request without a card raises; nothing carries on
    quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' (CLI: --device cpu) to run the "
            "plain torch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # Geometry: Y rows x X columns of the full lattice (both colors).
    nrows: int = 2048
    ncols: int = 2048

    # Temperature: explicit `temp` wins, else alpha * TCRIT.
    temp: float | None = None
    alpha: float | None = None

    seed: int = SEED_DEF

    # Update backend: "xla", "bit1", "packed", "dense" or "mxu"
    # (ops/registry.py).
    backend: str = "xla"

    # RNG mode, any of rng.RNG_MODES.
    rng: str = "threefry13"

    # Iterations (-w / -n).
    nwarmup: int = 0
    niters: int = 1

    # Measurement cadence: every print_freq steps, or the 2^(j/4) schedule.
    print_freq: int = 0
    print_exp: bool = False
    exp_thinned: bool = False

    # Early exit when |magnetization - tgt_magn| < 1e-3 (-m).
    tgt_magn: float | None = None

    # Temperature ramp: temp += temp_step every temp_freq steps.
    temp_step: float = 0.0
    temp_freq: int = 0

    # Quenched +-J disorder: P(antiferro link), and the links' own seed
    # (default: seed).
    j_prob: float | None = None
    j_seed: int | None = None

    # Uniform external field h.
    field: float = 0.0

    # Sub-lattice replicas: independent xsl x ysl tiles of the lattice.
    xsl: int | None = None
    ysl: int | None = None

    # Row slabs the lattice is split over (parallel/mesh.py), and the
    # split of each slab's sweep into an interior and two boundary bands
    # (ndev > 1; the same trajectory either way).
    ndev: int = 1
    halo_overlap: bool = False

    # Output toggles: lattice dumps (-o) and correlation files (-c).
    dump_lattice: bool = False
    corr_out: bool = False

    # Torch device of the state: "cuda" (default) or "cpu". The one field
    # the JAX package's config lacks: its JSON form leaves it out.
    device: str = "cuda"

    def __post_init__(self):
        if self.nrows <= 0 or self.ncols <= 0:
            raise ValueError("lattice dimensions must be positive")
        if self.ncols % 2:
            raise ValueError("ncols must be even (checkerboard splits rows in half)")
        if self.nrows % 2:
            raise ValueError("nrows must be even (row parity must be periodic)")
        if (self.ncols // 2) % 4:
            raise ValueError("ncols must be a multiple of 8 (Philox quad draws)")
        if self.backend not in ("xla", "dense", "packed", "bit1", "mxu"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.rng not in RNG_MODES:
            raise ValueError(f"unknown rng mode {self.rng!r}; "
                             f"one of {sorted(RNG_MODES)}")
        if self.rng.startswith("chacha") and (self.ncols // 2) % 16:
            # One ChaCha block yields 16 u32 words; the compact half-row
            # must consume whole blocks (plane modes additionally require
            # the backend's own ncols % 64).
            raise ValueError("chacha rng modes need ncols multiple of 32 "
                             "(16-word ChaCha blocks per compact half-row)")
        if self.backend == "packed" and self.ncols % (2 * SPINS_PER_WORD):
            raise ValueError("packed backend needs ncols multiple of 16")
        if self.backend == "bit1" and self.ncols % 64:
            raise ValueError("bit1 backend needs ncols multiple of 64 "
                             "(32 spins per word per color)")
        if self.backend == "mxu" and self.ncols % 256:
            raise ValueError("mxu backend needs ncols multiple of 256")
        if self.nrows % self.ndev:
            raise ValueError("nrows must divide evenly over devices")
        if (self.nrows // self.ndev) % 2:
            raise ValueError("per-device slab height must be even")
        if (self.xsl is None) != (self.ysl is None):
            raise ValueError("specify both xsl and ysl or neither")
        if self.xsl is not None:
            if self.ncols % self.xsl or self.xsl % 2:
                raise ValueError("xsl must be even and divide ncols")
            if self.nrows % self.ysl or self.ysl % 2:
                raise ValueError("ysl must be even and divide nrows")
            if (self.nrows // self.ndev) % self.ysl:
                raise ValueError(
                    "ysl must divide the per-device slab height "
                    f"({self.nrows // self.ndev})")
        if self.j_prob is not None and not (0.0 <= self.j_prob <= 1.0):
            raise ValueError("j_prob must be in [0, 1]")
        if self.field != 0.0:
            serial = self.rng == "hw" or plane_bits(self.rng) > 0
            if self.backend == "mxu":
                raise ValueError(
                    "external field is not supported on the mxu backend "
                    "(its 3-threshold accept assumes the h = 0 mirror "
                    "symmetry); use bit1, xla, dense, or packed")
            if self.backend == "bit1" and not serial:
                raise ValueError(
                    "external field on the bit1 backend uses the 10-class "
                    "bit-serial accept: pick a bit-plane rng mode "
                    "(philox7b/threefry13b/chacha8b/...) or hw; u32 "
                    "full-table field runs live on xla/dense/packed")
            if self.backend in ("dense", "packed") and serial:
                raise ValueError(
                    "external field on the dense/packed backends needs a "
                    "u32-contract rng mode (their full-table accepts "
                    "consume u32 draws); bit-plane/hw field runs live on "
                    "bit1 and xla")
            # xla supports every rng mode: the "...b" modes take the same
            # 10-class bit-serial accept as bit1; the u32 modes and hw
            # compare u32 draws against the full 2 x 5 table.

    @property
    def temperature(self) -> float:
        if self.temp is not None:
            return float(self.temp)
        a = self.alpha if self.alpha is not None else ALPHA_DEF
        return float(a) * TCRIT

    @property
    def local_rows(self) -> int:
        return self.nrows // self.ndev

    @property
    def nspins(self) -> int:
        return self.nrows * self.ncols

    def to_json(self) -> str:
        """The JAX package's SimConfig JSON of this config: its fields in
        its order, without `device` (the checkpoint header's config)."""
        fields = dataclasses.asdict(self)
        del fields["device"]
        return json.dumps(fields)

    @classmethod
    def from_json(cls, s: str, device: str = "cuda") -> "SimConfig":
        """The config of a JAX-format JSON string, on `device`."""
        return cls(**json.loads(s), device=device)
