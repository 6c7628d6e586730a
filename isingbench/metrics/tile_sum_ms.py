"""Device time of the replicas' int64 tile sums (the program's `tile_sums`
span in observables.replica_up_counts, timed by its CUDA events), mean over
the samples of the traced slice."""

from isingbench import program_spans


def read(run):
    return program_spans.mean(
        (s.device_s for s in program_spans.named("tile_sums") or ()), 1e3)
