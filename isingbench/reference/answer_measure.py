"""The reference's reading of `Simulation.measure`: the whole lattice's up
and down spins, counted on the program's final words a block of rows at a
time. A global count says nothing of one band, so there is no
`band_diffs`."""

from __future__ import annotations

import torch

BLOCK_ROWS = 2048


def block_rows(cfg) -> int:
    return BLOCK_ROWS


def partial(s, cfg):
    """Up spins of a block of decoded rows (uint8, 1 up)."""
    return s.to(torch.int64).sum().cpu()


def diffs(answer, partials, cfg) -> int:
    """The answer's integers (up, down) that differ from the count."""
    up = int(sum(int(p) for p in partials))
    return int(answer["up"] != up) + int(answer["down"] != cfg.nspins - up)
