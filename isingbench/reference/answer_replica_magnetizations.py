"""The reference's reading of `Simulation.replica_magnetizations`: each
ysl x xsl replica's |m|, row-major over the replica grid, judged as the
integer |2 ups - n| behind it (n the replica's spins)."""

from __future__ import annotations

import numpy as np
import torch

from isingbench.reference import ising as ref


def block_rows(cfg) -> int:
    """A row of whole replicas."""
    return cfg.ysl


def partial(s, cfg):
    return ref.tile_ups(s, cfg.xsl, cfg.ysl).view(-1).cpu()


def abs_2m(ups, n: int):
    """|2 * ups - n|: the integer behind |m| of n spins."""
    return (2 * ups - n).abs()


def _answer_ints(answer, n: int):
    got = np.rint(np.asarray(answer) * n).astype(np.int64)
    return torch.from_numpy(got)


def diffs(answer, partials, cfg) -> int:
    n = cfg.xsl * cfg.ysl
    want = abs_2m(torch.cat(partials), n)
    return int((_answer_ints(answer, n) != want).sum())


def band_diffs(state, answer, bands, band) -> int:
    """The replicas of one followed band (a row of whole replicas, as the
    reference has them at that measurement) against the answer's."""
    n = bands.xsl * bands.ysl
    per_row = bands.ncols // bands.xsl
    r = bands.starts[band] // bands.ysl
    want = abs_2m(ref.tile_ups(state, bands.xsl, bands.ysl), n).cpu()
    got = _answer_ints(answer[r * per_row:(r + 1) * per_row], n)
    return int((got != want.view(-1)).sum())
