"""Device time of one slab's up count inside the measurement (the
program's `count` span, timed by its CUDA events), mean over the slabs and
the measurements of the traced slice."""

from isingbench import program_spans


def read(run):
    return program_spans.mean(
        (s.device_s for s in program_spans.named("count") or ()), 1e3)
