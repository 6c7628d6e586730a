"""Seconds from the process's start to the window's: imports, CUDA
contexts, the kernels' build or load, the lattice's initialization and
the warm-up."""


def read(run):
    return run.setup_s
