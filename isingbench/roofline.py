"""Peaks of the card and the least work of a bit1 color phase, from shapes.

A kernel's share of its roofline is the least time the card could take for
the kernel's work, over the time it took. The least time is the larger of
two bounds:

* bytes: each word of state the phase reads read once, each it writes
  written once, at the data sheet's memory bandwidth;
* operations: the instructions that the generator's definition and the
  update need a site, one slot each, at the most the card can start (4
  schedulers x 32 lanes an SM a clock, at the highest boost clock).
  Loads, stores, addresses and control are counted free, and so is work on
  values that are the same for every site of a launch (the key schedule,
  the thresholds): so the count is what any implementation must execute,
  whatever its code, and the share cannot pass 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 132 SMs, 1980 MHz boost, 3.35 TB/s HBM3.
H100 = {"sms": 132, "ops_per_sm_clock": 4 * 32, "clock_hz": 1.98e9,
        "hbm_bytes_per_s": 3.35e12}

# Philox4x32: a round is two 32 x 32 -> 64 multiplies (IMAD.WIDE.U32, one
# instruction each, hi and lo together) and two three-input XORs (LOP3);
# one call yields the draws of four sites.
PHILOX_OPS_PER_ROUND = 4
PHILOX_SITES_PER_CALL = 4
# The u32 accept: a site's draw compared with the thresholds of the two
# classes that draw (dE = 4 and dE = 8), one ISETP each; the predicates
# go into the flip word at a fraction of an instruction a site (P2R packs
# seven), counted free.
ACCEPT_OPS_PER_SITE = 2
# The update of a word of 32 sites, in three-input logic ops (LOP3): the
# carry-save count of four neighbour words into three bit planes (6), the
# classes of the mirrored count (5), the flip word (2), the XOR into the
# state (1).
UPDATE_OPS_PER_WORD = 14
SITES_PER_WORD = 32
WORD_BYTES = 4


def philox_rounds(rng: str) -> int:
    """Rounds of a u32 Philox mode of the program's rng table."""
    rounds = {"philox": 10, "philox7": 7}
    if rng not in rounds:
        raise ValueError(f"no operation count for rng mode {rng!r}")
    return rounds[rng]


def bit1_phase_sites(rows: int, ncols: int) -> int:
    """Sites a color phase updates: half of rows x ncols."""
    return rows * ncols // 2


def bit1_phase_ops(rows: int, ncols: int, rng: str) -> float:
    sites = bit1_phase_sites(rows, ncols)
    per_site = (philox_rounds(rng) * PHILOX_OPS_PER_ROUND
                / PHILOX_SITES_PER_CALL + ACCEPT_OPS_PER_SITE
                + UPDATE_OPS_PER_WORD / SITES_PER_WORD)
    return sites * per_site


def bit1_phase_bytes(rows: int, ncols: int) -> int:
    """The phase's own color read and written, the other color read."""
    words = bit1_phase_sites(rows, ncols) // SITES_PER_WORD
    return 3 * words * WORD_BYTES


def bound_s(ops: float, nbytes: float, peaks=H100):
    """(seconds, "operations" or "bytes"): the least time and its bound."""
    t_ops = ops / (peaks["sms"] * peaks["ops_per_sm_clock"]
                   * peaks["clock_hz"])
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bit1_phase_bound_s(rows: int, ncols: int, rng: str):
    """The least time of one color phase over rows x ncols."""
    return bound_s(bit1_phase_ops(rows, ncols, rng),
                   bit1_phase_bytes(rows, ncols))
