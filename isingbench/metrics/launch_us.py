"""Host time inside the harness's `advance` spans (`driver.py` and the step
loop enqueueing the steps) over the kernel launches the port's wrappers
counted there, outside the traced slice."""


def read(run):
    s = [x for x in run.spans
         if x.name == "advance" and x.interval >= 0 and not x.traced]
    n = sum(x.launches for x in s)
    return 1e6 * sum(x.seconds for x in s) / n if n else None
