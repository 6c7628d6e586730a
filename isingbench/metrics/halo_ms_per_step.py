"""Device time of the copies between devices (the halo rows of the row
slabs) in the traced slice, summed over the devices, over the slice's
steps."""

from isingbench import trace as tr


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    per = tr.op_us(run.trace, lambda name: "PtoP" in name)
    if not sum(n for _, n in per.values()):
        return None
    return 1e-3 * sum(u for u, _ in per.values()) / run.traced_steps
