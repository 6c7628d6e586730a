"""The bit1 sweep kernel's share of its roofline: the least time the card
could take for the launches of the traced slice (roofline.py, from the
shapes: a launch is one slab's color phase) over their device time."""

from isingbench import roofline
from isingbench import trace as tr

KERNEL = "bit1_sweep_kernel"


def read(run):
    if run.trace is None:
        return None
    per = tr.op_us(run.trace, lambda name: KERNEL in name)
    us = sum(u for u, _ in per.values())
    launches = sum(n for _, n in per.values())
    if not launches or not us:
        return None
    bound, _ = roofline.bit1_phase_bound_s(run.cfg.local_rows,
                                           run.cfg.ncols, run.cfg.rng)
    return 100.0 * bound * launches / (1e-6 * us)
