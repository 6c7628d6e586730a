"""What decides a run's `correct` where the configuration names no check of
its own: its states and answers against the plain reference
(reference/ising.py, checkerboard Metropolis), which follows the program
step by step. The harness calls it as it calls a configuration's
checks/<name>.py: `LIMITS`, `follow`, `final` and `verdict` (harness.py
says what each is asked); the functions below them do the work.

A run of the full cell is thousands of steps of a lattice of up to 2^34
spins: a plain reference cannot redo it in a window's time. So the check
follows bands of rows, fixed from the seed, in device copies that the
harness takes at every measurement, where the device has synchronized:

* the start: the program's initial lattice in each band against the
  reference's, worked out from the seed;
* the steps: from the band at one measurement, the reference runs the
  interval's steps and compares the band at the next: the warm-up's
  interval (from the reference's own start), the window's first, its
  last, whose draws are those of the steps the window reached, and
  intervals drawn from the seed over the whole window by reservoir
  sampling, so that every interval of the window is as likely to be
  followed. Rows depend on rows at most two away a step, so a band of the
  full lattice is 2 * (2 * every + VALID_HALF) rows about its centre and
  its middle 2 * VALID_HALF rows are compared; a band of replicas is one
  row of whole replicas, periodic, compared whole;
* the answers: the last measurement against the reference's reading of
  the program's final words, a block of rows at a time, and, where the
  traffic's reader can judge a band (the replicas' |m|), every followed
  band's answer at its measurement against the reference's state there.

The configuration's storage is read by reference/storage_<backend>.py and
the traffic's answers judged by reference/answer_<call>.py, which the
harness finds by name and hands in. Bands sit on every slab boundary (the
halo rows between devices, and the lattice's own wrap) and at a row drawn
from the seed; with replicas, on the first and the last row of replicas
and one drawn from the seed. Every compared number is a count of differing
bits or integers: each limit is 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import ising as ref

VALID_HALF = 8
LIMITS = {"init_bits": 0, "step_bits": 0, "answer_diffs": 0}


def slabs(sim):
    """(black slabs, white slabs) of the program's state, one device or
    many."""
    b, w = sim.black, sim.white
    return (list(b), list(w)) if isinstance(b, (list, tuple)) else ([b], [w])


class Bands:
    """The rows the check follows, fixed from the seed."""

    def __init__(self, cfg, every: int, seed: int):
        Y = cfg.nrows
        rng = np.random.default_rng([seed, 1])
        self.Y, self.ncols = Y, cfg.ncols
        self.xsl, self.ysl = cfg.xsl, cfg.ysl
        if cfg.xsl is not None:
            # The first and last rows of replicas, and one drawn.
            self.height, n = cfg.ysl, Y // cfg.ysl
            picked = {0, n - 1, int(rng.integers(n))}
            self.starts = [r * cfg.ysl for r in sorted(picked)]
        else:
            half = 2 * every + VALID_HALF
            self.height = 2 * half
            L = Y // cfg.ndev
            centres = [k * L for k in range(cfg.ndev)]
            centres.append(int(rng.integers(Y)))
            self.starts = [(c - half) % Y for c in centres]

    def rows(self, band: int):
        return (self.starts[band] + torch.arange(self.height)) % self.Y

    def valid(self, nsteps: int):
        """The rows of a band that nsteps steps leave exact."""
        if self.xsl is not None:
            return slice(None)
        return slice(2 * nsteps, self.height - 2 * nsteps)

    def _runs(self, band: int, L: int):
        r, left = self.starts[band], self.height
        while left:
            k, off = divmod(r, L)
            take = min(L - off, left)
            yield k, off, off + take
            r, left = (r + take) % self.Y, left - take

    def grab(self, sim, out=None):
        """Device copies of every band's rows of both colors, each part on
        its slab's device: [(black parts, white parts)], new or copied
        into `out`, a grab of the same shapes."""
        bs, ws = slabs(sim)
        L = bs[0].shape[0]
        fresh = []
        for band in range(len(self.starts)):
            runs = list(self._runs(band, L))
            fresh.append(([bs[k][a:b] for k, a, b in runs],
                          [ws[k][a:b] for k, a, b in runs]))
        if out is None:
            return [([p.clone() for p in b], [p.clone() for p in w])
                    for b, w in fresh]
        _assign(out, fresh)
        return out


def _assign(dst, src):
    for (db, dw), (sb, sw) in zip(dst, src):
        for d, x in zip(db + dw, sb + sw):
            d.copy_(x)


class Snapshots:
    """The bands at the measurements that bound the followed intervals.

    Measurement 0 is the start, 1 the window's start (after the warm-up),
    then one a window's interval. Followed: (0, 1), (1, 2), the last, and
    `draws` of the pairs (m - 1, m), m >= 3, picked as they arrive by
    reservoir sampling (Vitter's algorithm R) from the seed. Every copy
    goes into buffers made at the start, so the memory a run holds does
    not depend on which intervals are drawn."""

    def __init__(self, bands: Bands, sim, draws: int, seed: int):
        self.bands, self.draws = bands, draws
        self.rng = np.random.default_rng([seed, 2])

        def entry():
            return [None, None, bands.grab(sim)]
        self.fixed = [entry() for _ in range(3)]
        self.tail = [entry(), entry()]
        self.slots = [(entry(), entry()) for _ in range(draws)]
        self.last = -1
        self.add(0, sim)

    @staticmethod
    def _set(dst, m, step, grabbed):
        dst[0], dst[1] = m, step
        _assign(dst[2], grabbed)

    def add(self, m: int, sim):
        cur = self.tail[m % 2]
        cur[0], cur[1] = m, sim.step
        self.bands.grab(sim, out=cur[2])
        self.last = m
        if m < 3:
            self._set(self.fixed[m], *cur)
            return
        i = m - 3
        slot = i if i < self.draws else int(self.rng.integers(i + 1))
        if slot < self.draws:
            a, b = self.slots[slot]
            self._set(a, *self.tail[(m - 1) % 2])
            self._set(b, *cur)

    @property
    def start(self):
        return self.fixed[0]

    def pairs(self):
        """The followed intervals, as (entry, entry) by their first m."""
        M = self.last
        cand = [(self.fixed[0], self.fixed[1]),
                (self.fixed[1], self.fixed[2]),
                (self.tail[(M - 1) % 2], self.tail[M % 2])]
        cand += [s for s in self.slots if s[0][0] is not None]
        out = {a[0]: (a, b) for a, b in cand
               if a[0] is not None and b[0] is not None and b[0] == a[0] + 1
               and b[0] <= M}
        return [out[m] for m in sorted(out)]


def _joined(parts, device):
    return torch.cat([p.to(device) for p in parts])


def check_bands(snaps: Snapshots, answers, storage, judge, *, rng: str,
                seed: int, temp: float, device):
    """init_bits, step_bits, answer_diffs of the followed bands' answers,
    and the steps checked."""
    bands = snaps.bands
    band_diffs = getattr(judge, "band_diffs", None)
    rounds = ref.philox_rounds(rng)
    X = bands.ncols
    out = {"init_bits": 0, "step_bits": 0, "answer_diffs": 0,
           "steps_checked": 0}

    def program(grabbed, band, rows):
        b, w = grabbed[band]
        return storage.decode(_joined(b, device), _joined(w, device), rows)

    # All bands are stepped as one tensor of rows: what runs across the
    # seam between two bands lies in rows that neither compares.
    nb, h = len(bands.starts), bands.height
    rows = torch.cat([bands.rows(b) for b in range(nb)]).to(device)

    def program_all(grabbed):
        return torch.cat([program(grabbed, b, rows[b * h:(b + 1) * h])
                          for b in range(nb)])

    start = ref.init_rows(seed, rows, X)
    out["init_bits"] += int((program_all(snaps.start[2]) ^ start).sum())
    for (m1, s1, g1), (m2, s2, g2) in snaps.pairs():
        k = s2 - s1
        s = start if m1 == 0 else program_all(g1)
        s = ref.run_steps(s, rows, seed=seed, step0=s1, nsteps=k, temp=temp,
                          xsl=bands.xsl, ysl=bands.ysl, rounds=rounds)
        got = program_all(g2)
        v = bands.valid(k)
        for band in range(nb):
            part = slice(band * h, (band + 1) * h)
            out["step_bits"] += int((s[part][v] ^ got[part][v]).sum())
            if band_diffs is not None:
                out["answer_diffs"] += band_diffs(s[part], answers[m2 - 1],
                                                  bands, band)
        out["steps_checked"] += k
    return out


def check_last_answer(sim, cfg, storage, judge, answer):
    """Integers of the last measurement that differ from the reference's
    reading of the program's final words, judge.block_rows(cfg) rows at a
    time (judge: the traffic's reference/answer_<call>.py)."""
    bs, ws = slabs(sim)
    L = bs[0].shape[0]
    block_rows = judge.block_rows(cfg)
    partials = []
    for k, (b, w) in enumerate(zip(bs, ws)):
        for a in range(0, L, block_rows):
            e = min(a + block_rows, L)
            rows = torch.arange(k * L + a, k * L + e, device=b.device)
            partials.append(judge.partial(storage.decode(b[a:e], w[a:e],
                                                         rows), cfg))
    return judge.diffs(answer, partials, cfg)


@dataclasses.dataclass
class Follower:
    """What the band check keeps of a run: the bands' snapshots, the
    reference's configuration, and the readers of the storage and of the
    traffic's answers."""
    snaps: Snapshots
    want: object
    storage: object
    judge: object

    def add(self, m: int, sim):
        self.snaps.add(m, sim)


def follow(cell, want, sim, root):
    """The bands of the program's state, fixed from the run's seed, with
    the storage reader of the configuration's backend and the answer reader
    of the traffic's call, both found by name under root."""
    from .harness import load   # the harness imports this module
    traffic = cell.traffic
    storage = load(root, "reference", f"storage_{want.backend}")
    judge = load(root, "reference", f"answer_{traffic['call']}")
    snaps = Snapshots(Bands(want, traffic["every"], want.seed), sim,
                      traffic["check_intervals"], want.seed)
    return Follower(snaps, want, storage, judge)


def final(follower: Follower, sim, answers) -> dict:
    """The last answer against the program's final words."""
    f = follower
    return {"answer_diffs": check_last_answer(sim, f.want, f.storage,
                                              f.judge, answers[-1])}


def verdict(follower: Follower, final: dict, answers, device) -> dict:
    """The followed bands' counts, with those of `final` added."""
    f = follower
    found = check_bands(f.snaps, answers, f.storage, f.judge,
                        rng=f.want.rng, seed=f.want.seed,
                        temp=f.want.temperature, device=device)
    for k, v in final.items():
        found[k] += v
    return found
