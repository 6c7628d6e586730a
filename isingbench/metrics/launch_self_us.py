"""Host time inside the program's `launch` spans (one around each call of
a kernel's wrapper: its argument checks and its launch) over the launches
they made, in the traced slice."""

from isingbench import program_spans


def read(run):
    spans = program_spans.named("launch")
    n = sum(s.counts.get("launches", 0) for s in spans or ())
    return 1e6 * sum(s.host_s for s in spans) / n if n else None
