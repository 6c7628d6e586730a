"""Spin updates the window completed over its wall time, measurements
included, as in a user's job; over several devices, their total."""


def read(run):
    return run.cfg.nspins * run.steps / (run.window_s * 1e9)
