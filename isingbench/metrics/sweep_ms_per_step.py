"""Device time of the bit1 sweep kernel in the traced slice, over the
slice's steps; over several devices, the mean of the devices."""

from isingbench import trace as tr

KERNEL = "bit1_sweep_kernel"


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    per = tr.op_us(run.trace, lambda name: KERNEL in name)
    us = sum(u for u, _ in per.values())
    if not us:
        return None
    return 1e-3 * us / len(per) / run.traced_steps
