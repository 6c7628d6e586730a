"""The 95th percentile (nearest rank), over the window's measurements, of
the time from one measurement's result reaching the host to the next
one's; the window starts as the warm-up's result arrives. Where the mix
dispatches ahead, a result reaches the host when its copy lands in host
memory, timed by the device's events (harness.Ahead)."""

import math


def read(run):
    t = [0.0] + list(run.result_times)
    gaps = sorted(b - a for a, b in zip(t, t[1:]))
    if not gaps:
        return None
    return 1e3 * gaps[math.ceil(0.95 * len(gaps)) - 1]
