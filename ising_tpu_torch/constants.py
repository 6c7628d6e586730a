"""Physical and numerical constants of the port.

A copy of the values the JAX package keeps in ``ising_tpu/constants.py``
(the port imports nothing of that package).
"""

# Critical temperature of the 2D Ising model, 2/ln(1+sqrt(2)).
TCRIT = 2.26918531421

# Default temperature coefficient: temperature = ALPHA_DEF * TCRIT.
ALPHA_DEF = 0.1

# Floor of the temperature ramp (-u STEP,FREQ).
MIN_TEMP = 0.05 * TCRIT

# Default seed.
SEED_DEF = 463463564571

# Early-exit tolerance on |magnetization - target| (-m).
TGT_MAGN_MAX_DIFF = 1.0e-3

# Largest distance of the 2-point correlation (-c).
MAX_CORR_LEN = 128

# Checkerboard colors.
BLACK = 0
WHITE = 1
