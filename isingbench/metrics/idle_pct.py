"""The share of the traced slice in which no operation ran on a device,
mean over the devices."""

from isingbench import trace as tr


def read(run):
    t = run.trace
    if t is None or not t.window_us:
        return None
    busy = [tr.busy_us(t, d) for d in t.devices]
    return 100.0 * (1.0 - sum(busy) / len(busy) / t.window_us)
