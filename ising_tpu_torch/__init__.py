"""ising-tpu-torch: the PyTorch / NVIDIA H100 port of ising_tpu.

A package beside the JAX package ``ising_tpu``, which stays the reference.
This slice runs the bit1 checkerboard-Metropolis path: counter-based
Philox/Threefry draws (u32 contract), T > 0 and the greedy T <= 0 quench,
on one device, with the half-sweep as a hand-written CUDA kernel
(csrc/bit1_sweep.cu). It imports torch and never jax or ising_tpu.
Entry points run on CUDA unless the caller passes device="cpu".
"""

from .config import SimConfig  # noqa: F401
from .constants import BLACK, TCRIT, WHITE  # noqa: F401
from .ops import available_backends, get_backend  # noqa: F401

__version__ = "0.1.0"
