"""Time of the harness's span around the traffic's measurement call, mean
over the window's measurements outside the traced slice: on the device's
events where the mix dispatches ahead (from before the call's first
operation to its answer's copy in host memory), else on the host's
clock, where the span ends with the answer on the host."""


def read(run):
    name = run.cell.traffic["span"]
    s = [x.seconds if x.device_s is None else x.device_s for x in run.spans
         if x.name == name and x.interval >= 0 and not x.traced]
    return 1e3 * sum(s) / len(s) if s else None
