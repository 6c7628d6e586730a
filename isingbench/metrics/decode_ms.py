"""Device time of the decode of the lattice's words into bit planes (the
program's `decode` span, timed by its CUDA events), mean over the samples
of the traced slice."""

from isingbench import program_spans


def read(run):
    return program_spans.mean(
        (s.device_s for s in program_spans.named("decode") or ()), 1e3)
