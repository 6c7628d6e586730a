"""Host time inside the program's `advance` spans less that of their
`launch` children (the step loop's own: the slabs' loop, the device
guards, the halo rows' enqueues) over the launches they made, in the
traced slice."""

from isingbench import program_spans


def read(run):
    advance = program_spans.named("advance")
    if not advance:
        return None
    ids = {id(s) for s in advance}
    launched = sum(s.host_s for s in program_spans.named("launch")
                   if id(s.parent) in ids)
    n = sum(s.counts.get("launches", 0) for s in advance)
    return 1e6 * (sum(s.host_s for s in advance) - launched) / n if n else None
