"""Parallel tempering (replica exchange) over a temperature ladder.

The port of ``ising_tpu/tempering.py``. K replicas of one quenched
disorder realization (cfg.j_seed) run at temperatures T_0 .. T_{K-1};
after every `sweeps_per_swap` sweeps, adjacent ladder pairs propose a
configuration exchange with probability

    p = min(1, exp((beta_i - beta_j) * (E_i - E_j))),   E = H(X) = -bondsum.

- Each rung is a full `Simulation`: any backend, any rng mode. Replicas
  share the quenched links through `j_seed` and take their own update
  streams through distinct seeds. Configurations move between rungs,
  never temperatures: a swap exchanges two pairs of tensor handles and
  does no work on the device.
- The decision is exact: the energies are int64 bond sums, and a raw u32
  from a scalar Philox4x32-10 stream (keyed by `swap_seed`, countered by
  (round, pair)) is compared with the integer threshold floor(p * 2^32)
  computed on the host. Trajectories and swap records are therefore
  the JAX package's, bit for bit, on every backend.
- Pairing alternates even rounds (0-1, 2-3, ...) and odd rounds (1-2,
  3-4, ...): the deterministic even-odd (DEO) schedule.
- A batched round (the default) enqueues every rung's sweeps, then every
  rung's energy and up-count partials, with no synchronisation, and
  brings the per-rung totals back in one transfer. `batched=False` keeps
  the per-rung path (advance, then swap_phase); both give the same
  records.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import SimConfig
from .driver import Simulation
from .parallel.mesh import refuse_over_processes

_M32 = 0xFFFFFFFF
# Philox4x32 round and Weyl constants (Random123), for the O(K) swap draws
# made on the host.
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32_scalar(ctr, key, rounds: int = 10):
    """Philox4x32 block on Python ints: (4-tuple ctr, 2-tuple key) -> 4 u32."""
    x0, x1, x2, x3 = (c & _M32 for c in ctr)
    k0, k1 = key[0] & _M32, key[1] & _M32
    for _ in range(rounds):
        p0 = _PHILOX_M0 * x0
        p1 = _PHILOX_M1 * x2
        x0, x1, x2, x3 = (((p1 >> 32) ^ x1 ^ k0) & _M32, p1 & _M32,
                          ((p0 >> 32) ^ x3 ^ k1) & _M32, p0 & _M32)
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return x0, x1, x2, x3


def swap_threshold_u32(dbeta: float, denergy: int) -> int:
    """floor(min(1, exp(dbeta * denergy)) * 2^32), in [0, 2^32]: 2^32 is
    the certain accept, so `u < t` is exact at both ends."""
    arg = dbeta * denergy
    if arg >= 0.0:
        return 1 << 32
    return int(math.exp(arg) * (1 << 32))


def _host_ints(parts):
    """[int(p.sum()) for p in parts], the sums stacked on the device and
    brought back in one transfer."""
    return torch.stack([p.sum() for p in parts]).cpu().tolist()


def equalize_ladder(temps, pair_acceptance, floor: float = 0.01):
    """One acceptance-equalizing feedback step on a ladder: the interior
    rungs move to uniform quantiles of the cumulative resistance
    r_i = max(1 - a_i, floor) along it, the ends fixed."""
    t = np.asarray(temps, np.float64)
    if t.size - 1 != len(pair_acceptance):
        raise ValueError("need one acceptance rate per adjacent pair")
    r = np.maximum(1.0 - np.asarray(pair_acceptance, np.float64), floor)
    lam = np.concatenate([[0.0], np.cumsum(r)])
    targets = np.linspace(0.0, float(lam[-1]), t.size)
    return [float(x) for x in np.interp(targets, lam, t)]


class ParallelTempering:
    """K-replica exchange over one quenched-disorder realization.

    cfg gives everything but the temperature (geometry, backend, rng,
    j_prob / j_seed, device); `temps` is the ladder, strictly positive, in
    rung order. Rung i runs `dataclasses.replace(cfg, temp=temps[i],
    seed=replica_seeds[i], j_seed=<shared>)`.
    """

    def __init__(self, cfg: SimConfig, temps, *, sweeps_per_swap: int = 8,
                 replica_seeds=None, swap_seed: int | None = None,
                 batched: bool = True):
        refuse_over_processes("parallel tempering")
        temps = [float(t) for t in temps]
        if len(temps) < 2:
            raise ValueError("parallel tempering needs at least 2 rungs")
        if any(t <= 0 for t in temps):
            raise ValueError("rung temperatures must be > 0 (beta finite)")
        if sweeps_per_swap < 1:
            raise ValueError("sweeps_per_swap must be >= 1")
        if cfg.field != 0.0:
            # Swaps compare bond energies only; a field term -h sum(s)
            # differs per replica and would bias the exchange.
            raise ValueError("parallel tempering supports field == 0 only")
        if replica_seeds is None:
            replica_seeds = [cfg.seed + 1000003 * i
                             for i in range(len(temps))]
        if len(replica_seeds) != len(temps):
            raise ValueError("one replica seed per rung")
        j_seed = cfg.seed if cfg.j_seed is None else cfg.j_seed
        self.temps = temps
        self.betas = [1.0 / t for t in temps]
        self.sweeps_per_swap = int(sweeps_per_swap)
        self.swap_seed = cfg.seed ^ 0x9E3779B97F4A7C15 if swap_seed is None \
            else int(swap_seed)
        self.sims = [Simulation(dataclasses.replace(
            cfg, temp=t, alpha=None, seed=int(s), j_seed=j_seed))
            for t, s in zip(temps, replica_seeds)]
        # replica_at[rung]: the replica (initial-state lineage) at that rung
        self.replica_at = list(range(len(temps)))
        self.round = 0
        self.attempts = [0] * (len(temps) - 1)
        self.accepts = [0] * (len(temps) - 1)
        # Round trips: _extreme[r] is the last ladder end replica r touched;
        # a bottom-top-bottom pair of flips is one round trip.
        self._extreme = [None] * len(temps)
        self._extreme[self.replica_at[0]] = "bottom"
        self._extreme[self.replica_at[-1]] = "top"
        self._flips = [0] * len(temps)
        self.batched = bool(batched)
        self._cache = None      # the last batched round's (H, up counts)
        # The JAX rule for taking a round's partials in one slab: while the
        # whole ladder's transients stay small (decoded byte planes at 4
        # bytes a spin where the backend has no word-domain energy); above
        # it, in row chunks. Both give the same numbers.
        be = self.sims[0].backend
        bytes_per_spin = 1 if hasattr(be, "energy_rows") else 4
        self._inline_obs = (len(self.sims) * cfg.nspins * bytes_per_spin
                            <= 1 << 31)

    def _swap_draw(self, pair: int) -> int:
        """One u32 for this (round, pair) proposal, from a counter stream of
        its own."""
        return philox4x32_scalar(
            (self.round & _M32, (self.round >> 32) & _M32, pair, 0x5EAB),
            (self.swap_seed & _M32, (self.swap_seed >> 32) & _M32))[0]

    def _do_swaps(self, H, *extras):
        """The DEO proposals of this round given the rung Hamiltonians H
        (exact ints). A swap exchanges the rungs' tensor handles; the
        `extras` lists (per-rung values) are permuted along."""
        for i in range(self.round % 2, len(self.sims) - 1, 2):
            j = i + 1
            self.attempts[i] += 1
            t = swap_threshold_u32(self.betas[i] - self.betas[j],
                                   H[i] - H[j])
            if self._swap_draw(i) < t:
                self.accepts[i] += 1
                si, sj = self.sims[i], self.sims[j]
                si.black, sj.black = sj.black, si.black
                si.white, sj.white = sj.white, si.white
                for lst in (H, self.replica_at, *extras):
                    lst[i], lst[j] = lst[j], lst[i]
        self.round += 1
        rb, rt = self.replica_at[0], self.replica_at[-1]
        if self._extreme[rb] == "top":
            self._flips[rb] += 1
        self._extreme[rb] = "bottom"
        if rt != rb:
            if self._extreme[rt] == "bottom":
                self._flips[rt] += 1
            self._extreme[rt] = "top"

    def swap_phase(self):
        """One DEO phase of exchange proposals, every rung's energy brought
        back in one transfer."""
        self._do_swaps([-e for e in _host_ints(
            [s._energy_rows() for s in self.sims])])

    def _advance_round_batched(self):
        step0 = self.sims[0].step
        assert all(s.step == step0 for s in self.sims), \
            "rungs advanced out of lockstep"
        for s in self.sims:
            s.advance(self.sweeps_per_swap)
        chunk = self.sims[0].cfg.nrows if self._inline_obs else 8192
        ers = [s._energy_rows_for(s.black, s.white, row_chunk=chunk)
               for s in self.sims]
        urs = [s._up_rows_for(s.black, s.white) for s in self.sims]
        totals = _host_ints(ers + urs)   # the round's one transfer
        K = len(self.sims)
        H = [-e for e in totals[:K]]
        ups = totals[K:]
        self._do_swaps(H, ups)
        self._cache = {"steps": tuple(s.step for s in self.sims),
                       "round": self.round, "H": H, "ups": ups}

    def advance_round(self):
        """sweeps_per_swap sweeps on every rung, then one swap phase:
        batched, one transfer for the round; else per rung."""
        if self.batched:
            self._advance_round_batched()
        else:
            for s in self.sims:
                s.advance(self.sweeps_per_swap)
            self.swap_phase()

    def run(self, nrounds: int):
        for _ in range(nrounds):
            self.advance_round()
        return self.stats()

    def stats(self):
        """Per-pair acceptance rates, the rung -> replica permutation and
        each replica's completed round trips (bottom-top-bottom)."""
        rates = [a / n if n else 0.0
                 for a, n in zip(self.accepts, self.attempts)]
        return {"round": self.round, "pair_acceptance": rates,
                "replica_at": list(self.replica_at),
                "round_trips": [f // 2 for f in self._flips]}

    def retemper(self, temps):
        """Move the rungs (not the configurations) to a new ladder, as with
        equalize_ladder(stats()["pair_acceptance"]). The acceptance
        counters restart; round trips persist. Each rung's backend takes
        the new temperature through Simulation.set_temperature (the greedy
        quench, the k-bit thresholds of the bit-plane modes and hw), so the
        next round steps with it."""
        temps = [float(t) for t in temps]
        if len(temps) != len(self.sims):
            raise ValueError("ladder size cannot change in retemper")
        if any(t <= 0 for t in temps):
            raise ValueError("rung temperatures must be > 0")
        self.temps = temps
        self.betas = [1.0 / t for t in temps]
        for s, t in zip(self.sims, temps):
            s.set_temperature(t)
        self.attempts = [0] * (len(temps) - 1)
        self.accepts = [0] * (len(temps) - 1)
        self._cache = None

    def measure(self):
        """Per-rung temp, magnetization, energy per spin and the exact
        integer Hamiltonian ("hamiltonian"): from the last batched round's
        transfer where the state is still that round's, else every rung's
        partials in one transfer."""
        c = self._cache
        if c is not None and c["round"] == self.round and \
                c["steps"] == tuple(s.step for s in self.sims):
            H, ups = c["H"], c["ups"]
        else:
            K = len(self.sims)
            totals = _host_ints(
                [s._up_rows_for(s.black, s.white) for s in self.sims]
                + [s._energy_rows() for s in self.sims])
            ups, H = totals[:K], [-e for e in totals[K:]]
        out = []
        for t, s, u, h in zip(self.temps, self.sims, ups, H):
            n = s.cfg.nspins
            out.append({"step": s.step,
                        "magnetization": abs(2 * u - n) / n,
                        "up": u, "down": n - u, "temp": t,
                        "energy": h / n, "hamiltonian": h})
        return out

    def collect_energies(self, nrounds: int):
        """Run nrounds and return each rung's series of total energies (the
        exact Hamiltonians measure() gives), float64: a multiple-histogram
        dataset at the fixed temperatures temps[k]."""
        out = [[] for _ in self.sims]
        for _ in range(int(nrounds)):
            self.advance_round()
            for k, m in enumerate(self.measure()):
                out[k].append(m["hamiltonian"])
        return [np.asarray(r, np.float64) for r in out]


def replica_overlap(pt_a: ParallelTempering, pt_b: ParallelTempering):
    """Per-rung Edwards-Anderson overlaps q_k between two independent
    ladders over the same quenched disorder, every rung's XOR counts in
    one transfer.

    Raises on ladders of other temperatures, geometry or disorder, and on a
    thermal seed that the two ladders share at any rung (swaps move
    configurations across rungs, so one shared stream couples them).
    """
    if pt_a.temps != pt_b.temps:
        raise ValueError("ladders must share the temperature grid")
    for k, (sa, sb) in enumerate(zip(pt_a.sims, pt_b.sims)):
        ca, cb = sa.cfg, sb.cfg
        if (ca.nrows, ca.ncols) != (cb.nrows, cb.ncols):
            raise ValueError("overlap needs matching lattice geometry")
        if (ca.j_prob, ca.j_seed) != (cb.j_prob, cb.j_seed):
            raise ValueError(
                "replica overlap needs the SAME disorder realization: "
                f"rung {k} has (j_prob, j_seed) = "
                f"({ca.j_prob}, {ca.j_seed}) vs ({cb.j_prob}, {cb.j_seed})")
    shared = ({s.cfg.seed for s in pt_a.sims}
              & {s.cfg.seed for s in pt_b.sims})
    if shared:
        raise ValueError(
            f"ladders share thermal seed(s) {sorted(shared)}; independent "
            "replicas need globally distinct seeds on every rung "
            "(pass different cfg.seed / replica_seeds)")
    neq = _host_ints([sa._overlap_neq_rows_with(sb)
                      for sa, sb in zip(pt_a.sims, pt_b.sims)])
    return [1.0 - 2.0 * n / s.cfg.nspins for n, s in zip(neq, pt_a.sims)]
