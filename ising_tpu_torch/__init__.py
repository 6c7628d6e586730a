"""ising-tpu-torch: the PyTorch / NVIDIA H100 port of ising_tpu.

A package beside the JAX package ``ising_tpu``, which stays the reference.
It runs checkerboard Metropolis on one device with the bit1 backend (the
half-sweep as hand-written CUDA kernels, csrc/) and the xla backend
(plain torch), in every rng mode, and with the packed backend (4 bits per
spin, its own CUDA kernel) in the u32 modes and hw, at T > 0 and in the
greedy quench, with the external field, quenched +-J disorder and
sub-lattice replicas; and Swendsen-Wang cluster updates (cluster.py), whose
labeler's passes are a CUDA kernel too. It writes and reads the JAX
package's lattice dumps, correlation files and checkpoints byte for byte
(io.py, checkpoint.py). Parallel tempering (tempering.py, --pt) exchanges
configurations over a temperature ladder on any backend, with the replica
overlap and the Fourier partials. The statistics (analysis.py,
reweight.py), the profiler hooks and plotting (utils/) and the native
hex codec (native/, g++) are the JAX package's, and examples/ holds its
seven example studies. It imports torch and never jax or ising_tpu.
Entry points run on CUDA unless the caller passes device="cpu".
"""

from .config import SimConfig  # noqa: F401
from .constants import BLACK, TCRIT, WHITE  # noqa: F401
from .ops import available_backends, get_backend  # noqa: F401

__version__ = "0.1.0"
