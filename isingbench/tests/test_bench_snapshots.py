"""The check follows intervals drawn over the whole window, from the seed,
and keeps the bands of each followed interval as they were at its two
measurements."""

from types import SimpleNamespace

import torch

from isingbench.check import Bands, Snapshots

GEOMETRY = SimpleNamespace(nrows=64, ncols=128, xsl=None, ysl=None, ndev=2)


class FakeSim:
    """Slabs whose every word holds the step the state is at."""

    def __init__(self):
        self.step = 0
        self.black = [torch.zeros(32, 2, dtype=torch.int32)
                      for _ in range(2)]
        self.white = [torch.zeros(32, 2, dtype=torch.int32)
                      for _ in range(2)]

    def advance(self, n):
        self.step += n
        for p in self.black + self.white:
            p.fill_(self.step)


def followed(seed: int, measurements: int, draws: int = 4):
    sim = FakeSim()
    snaps = Snapshots(Bands(GEOMETRY, 1, seed), sim, draws, seed)
    for m in range(1, measurements + 1):
        sim.advance(3)
        snaps.add(m, sim)
    return snaps.pairs()


def test_each_followed_interval_holds_its_own_measurements():
    for (m1, s1, g1), (m2, s2, g2) in followed(7, 200):
        assert m2 == m1 + 1 and (s1, s2) == (3 * m1, 3 * m2)
        for (b1, w1), (b2, w2) in zip(g1, g2):
            assert all(int(p.max()) == s1 == int(p.min()) for p in b1 + w1)
            assert all(int(p.max()) == s2 == int(p.min()) for p in b2 + w2)


def test_the_fixed_intervals_and_the_last_are_followed():
    starts = [a[0] for a, _ in followed(7, 200)]
    assert starts[:2] == [0, 1] and starts[-1] == 199
    assert len(starts) == 3 + 4


def test_draws_reach_the_whole_window():
    # Over many seeds every part of a 400-interval window is followed.
    drawn = set()
    for seed in range(40):
        drawn |= {a[0] for a, _ in followed(seed, 400)}
    assert all(any(lo <= m < lo + 40 for m in drawn)
               for lo in range(2, 400, 40))
    assert max(m for m in drawn if m < 399) > 350


def test_draws_come_from_the_seed():
    assert ([a[0] for a, _ in followed(11, 300)]
            == [a[0] for a, _ in followed(11, 300)])
    assert ([a[0] for a, _ in followed(11, 300)]
            != [a[0] for a, _ in followed(12, 300)])
