"""Simulation driver of the port: state, step loop and measurement loop.

The port of ``ising_tpu/driver.py``: the same print schedules, the same
log lines, the same flips/ns and bandwidth formula, the temperature ramp,
the external field, quenched +-J disorder and sub-lattice replicas, the
lattice dumps (-o) and correlation files (-c) written at each
measurement, and checkpoint and resume in the JAX package's file format;
the overlap with another run's state and the Fourier partials. Steps run
as host-issued launches; the host synchronises only at measurement
events.

With cfg.ndev > 1 the state is ndev row slabs over a mesh
(parallel/mesh.py): `black` and `white` are lists of per-slab storage,
the disorder is built per slab, and every observable is computed slab by
slab (a slab's bonds to the rows below it read the next slabs' rows)
and joined on the first slab's device, so a measurement is one transfer
and no step gathers the lattice. Lines, integers and files equal the
one-device run's, as in the JAX package.

In a group of processes (parallel/mesh.py, ``initialize_multihost``) each
process builds and steps only its own slabs (global slabs first_slab(mesh)
onward), its observables' int64 partials are summed over the group
(mesh.all_sum), so every rank prints one device's lines, and -o writes
each rank's slabs under their global indices. What would need the whole
lattice in one process (bits(), links(), -c, checkpoints, the overlap,
the Fourier partials) raises NotImplementedError there.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from . import io as lio
from . import observables
from .config import SimConfig, resolve_device
from .constants import (BLACK, MAX_CORR_LEN, MIN_TEMP, TGT_MAGN_MAX_DIFF,
                        WHITE)
from .lattice import init_store, links_to_color_planes
from .models import ising
from .ops import get_backend
from .ops.bit1 import pack_bits1, unpack_bits1
from .parallel import make_sharded_stepper
from .parallel.halo import process_rows_after, ring_rows, rows_after
from .parallel.mesh import (all_sum, first_slab, gather_rows, process_group,
                            refuse_over_processes, slab_devices, split_rows)
from .utils import profiling


def exponential_print_steps(nsteps: int) -> list[int]:
    """Measurement steps: the distinct values of rint(2^(j/4)) <= nsteps."""
    out = []
    j = 0
    while True:
        t = int(round(2.0 ** (j / 4.0)))
        if t > nsteps:
            break
        if not out or t != out[-1]:
            out.append(t)
        j += 1
    return out


def reference_exp_times(nsteps: int) -> list[int]:
    """The -E schedule: from 152, the first rint(2^(j/4)) at least twice
    the previous entry, up to 200 entries (callers filter to <= nsteps)."""
    times = [152]
    t = 0
    j = 0
    while j < nsteps and t < nsteps:
        t = int(round(2.0 ** (j / 4.0)))
        if t >= 2 * times[-1] and len(times) < 200:
            times.append(t)
        j += 1
    return times


def _row_chunk(Y: int, chunk_rows: int) -> int:
    """An even chunk height of at most chunk_rows that divides Y."""
    R = min(Y, chunk_rows)
    R -= R % 2
    while Y % R:
        R -= 2
    return R


def build_disorder(cfg, backend, chunk_rows: int = 8192, device="cpu",
                   mesh=None):
    """(links, links_packed, jplanes) for cfg.j_prob, built in row chunks.

    The links of each chunk are drawn from the same counter stream as a
    one-shot draw, and each color's flag planes are projected row-locally
    with the one v halo row above the chunk, so the result does not depend
    on the chunk height. With ncols % 64 == 0 the (v, h) links stay
    bit-packed, parity-split as (vE, vO, hE, hO) word planes: the layout
    the word-domain disordered energy reads. When the backend can project
    the flags in its kernel (bit1 on one device without replicas), that
    store is the jplanes of both colors and no per-color planes are made;
    otherwise jplanes is (black's, white's) (j_up, j_dn, j_same, j_off)
    in the backend's encoding.

    Over a mesh the chunks divide the slab height, each made on its slab's
    device, and links and each color's jplanes are lists with one entry a
    slab (in a group of processes, a slab this process holds).
    """
    Y, X = cfg.nrows, cfg.ncols
    enc = getattr(backend, "encode_jplanes", lambda p: p)
    links_packed = X % 64 == 0
    nslab = 1 if mesh is None else len(mesh)
    L = Y if mesh is None else cfg.local_rows
    first = 0 if mesh is None else first_slab(mesh)
    R = _row_chunk(L, chunk_rows)
    split = (links_packed and mesh is None
             and getattr(backend, "split_links_capable", False))
    if split:
        backend.split_links = True
    jseed = cfg.seed if cfg.j_seed is None else cfg.j_seed
    link_parts, jb_parts, jw_parts = [], [], []
    for r in range(first * L, (first + nslab) * L, R):
        dev = device if mesh is None else mesh[r // L - first]
        v_s, h_s = ising.generate_disorder_links(
            jseed, Y, X, cfg.j_prob, row0=r, local_rows=R, device=dev)
        if not split:
            v_up = None
            if R < Y:
                v_up, _ = ising.generate_disorder_links(
                    jseed, Y, X, cfg.j_prob, row0=(r - 1) % Y,
                    local_rows=1, device=dev)
            jb_parts.append(tuple(enc(
                links_to_color_planes(v_s, h_s, BLACK, v_up=v_up))))
            jw_parts.append(tuple(enc(
                links_to_color_planes(v_s, h_s, WHITE, v_up=v_up))))
        if links_packed:
            link_parts.append(tuple(pack_bits1(p) for p in (
                v_s[:, 0::2], v_s[:, 1::2], h_s[:, 0::2], h_s[:, 1::2])))
        else:
            link_parts.append((v_s, h_s))
        del v_s, h_s

    def cat(parts):
        return tuple(torch.cat([p[i] for p in parts])
                     for i in range(len(parts[0])))

    if mesh is not None:
        per = L // R
        slabs = lambda parts: [cat(parts[k * per:(k + 1) * per])
                               for k in range(nslab)]
        return (slabs(link_parts), links_packed,
                (slabs(jb_parts), slabs(jw_parts)))
    links = cat(link_parts)
    if split:
        return links, links_packed, (links, links)
    return links, links_packed, (cat(jb_parts), cat(jw_parts))


class Simulation:
    """One Ising MC run: state on `cfg.device`, stepper, measurements.

    state: compact (black, white) uint8 planes to start from (torch or
    numpy); storage: planes already in this backend's storage (a resume;
    whole, or one per slab); step0: the step reached; temp: the
    temperature reached, where a ramp has moved it from cfg's. mesh: the
    devices of cfg.ndev row slabs (mesh.slab_devices; default
    make_mesh(cfg.ndev, device=cfg.device)). In a group of processes the
    mesh holds this process's slabs, from global slab `slab0` on; state is
    still the whole lattice's planes (each process takes its rows), storage
    this process's slabs."""

    def __init__(self, cfg: SimConfig, *, state=None, storage=None,
                 step0: int = 0, temp: float | None = None, mesh=None):
        if cfg.corr_out:
            refuse_over_processes("-c (correlation output)")
        self.cfg = cfg
        self.mesh = slab_devices(cfg, mesh)
        self.slab0 = first_slab(self.mesh) if self.mesh else 0
        self.device = (self.mesh[0] if self.mesh
                       else resolve_device(cfg.device))
        self.temp = float(temp) if temp is not None else cfg.temperature
        self.step = int(step0)
        self.backend = get_backend(cfg)
        if self.temp != cfg.temperature:
            # The accept follows the temperature reached: the greedy
            # quench at T <= 0, the k-bit thresholds of the plane modes.
            self.backend.retune(self.temp, cfg.field)
        # Quenched disorder: the link store (bit-packed and parity-split
        # when ncols % 64 == 0; links() gives the uint8 planes) and the
        # stepper's J planes; over a mesh, one of each a slab.
        self._links_store, self._links_packed, jplanes = None, False, None
        if cfg.j_prob is not None:
            self._links_store, self._links_packed, jplanes = build_disorder(
                cfg, self.backend, device=self.device, mesh=self.mesh)
        with profiling.setup("stepper"):
            self.shardings, self._step_n = make_sharded_stepper(
                cfg, self.backend, mesh=self.mesh, jplanes=jplanes)
        if self.mesh is None:
            self.black, self.white = self._one_store(state, storage)
        else:
            self.black, self.white = self._slab_stores(state, storage)
        self._thr = ising.threshold_table(self.temp, cfg.field)

    def _one_store(self, state, storage):
        cfg = self.cfg
        if storage is not None:
            return storage
        if state is None:
            return self._init_store(self.device)
        # A copy: the kernels update the storage in place, and dense's and
        # mxu's storage is these planes.
        return self.backend.encode(*(
            torch.as_tensor(p).to(self.device, torch.uint8, copy=True)
            for p in state))

    def _slab_stores(self, state, storage):
        """([black slabs], [white slabs]): slab k of the storage on
        mesh[k], global rows [(slab0 + k) * local_rows, (slab0 + k + 1) *
        local_rows); the initial state is drawn slab by slab on the slab's
        device."""
        cfg, mesh, enc = self.cfg, self.mesh, self.backend.encode
        L = cfg.local_rows
        rows = [(self.slab0 + k) * L for k in range(len(mesh))]
        if storage is not None:
            b, w = storage
            if isinstance(b, (list, tuple)):
                return ([x.to(d) for x, d in zip(b, mesh)],
                        [x.to(d) for x, d in zip(w, mesh)])
            refuse_over_processes("whole-lattice storage")
            return split_rows(b, mesh), split_rows(w, mesh)
        if state is None:
            pairs = [self._init_store(d, row0=r, local_rows=L)
                     for r, d in zip(rows, mesh)]
        else:
            pairs = [enc(*(torch.as_tensor(p)[r:r + L]
                           .to(d, torch.uint8, copy=True) for p in state))
                     for r, d in zip(rows, mesh)]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def _init_store(self, device, **rows):
        """init_store's random start on `device` (of the rows `rows`
        names), in a setup.lattice span that records the device allocator's
        peak at its end."""
        cfg = self.cfg
        with profiling.setup("lattice", device) as span:
            out = init_store(cfg.seed, cfg.nrows, cfg.ncols,
                             self.backend.encode, device=device, **rows)
            if device.type == "cuda":
                span.counts["peak_bytes"] = torch.cuda.max_memory_allocated(
                    device)
        return out

    def _per_slab(self, fn, black, white, tail_rows: int = 0, join=None):
        """fn(k, black_k, white_k, tail) of each slab k of the given storage,
        the results joined on self.device (concatenated along their last
        axis, or by `join`). tail is None on one device (the planes' own
        wrap), else the (black, white) tail_rows rows that follow slab k:
        in a group of processes the last slab's from the next rank."""
        if not isinstance(black, list):
            return fn(0, black, white, None)
        last = None
        if tail_rows and process_group()[1] > 1:
            last = (process_rows_after(black, tail_rows),
                    process_rows_after(white, tail_rows))
        parts = []
        for k, (b, w) in enumerate(zip(black, white)):
            tail = None
            if last is not None and k == len(black) - 1:
                tail = last
            elif tail_rows:
                tail = (rows_after(black, k, tail_rows),
                        rows_after(white, k, tail_rows))
            part = fn(k, b, w, tail)
            with profiling.span("gather"):
                parts.append(part.to(self.device))
        return torch.cat(parts, dim=-1) if join is None else join(parts)

    def _decode_slabs(self):
        """[(black, white)] decoded uint8 planes of each slab."""
        out = []
        for b, w in zip(self.black, self.white):
            with profiling.span("decode", b.device):
                out.append(self.backend.decode(b, w))
        return out

    def bits(self):
        """Current (black, white) uint8 bit planes (decoded), on
        self.device."""
        if self.mesh is None:
            with profiling.span("decode", self.black.device):
                return self.backend.decode(self.black, self.white)
        refuse_over_processes("the whole lattice's planes (bits())")
        pairs = self._decode_slabs()
        return tuple(gather_rows([p[i] for p in pairs]) for i in (0, 1))

    def _links_slab_of(self, store, r: int, n: int, chunk: int = 8192):
        """(v, h) uint8 link rows [r, r+n) of the given store (one slab's,
        over a mesh); a packed store is unpacked and re-interleaved in row
        slabs of at most `chunk` rows, so the transient stays one slab's."""
        if not self._links_packed:
            v, h = store
            return v[r:r + n], h[r:r + n]
        out = [torch.empty((n, self.cfg.ncols), dtype=torch.uint8,
                           device=store[0].device) for _ in range(2)]
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            for plane, dst, parity in zip(store, (0, 0, 1, 1), (0, 1, 0, 1)):
                out[dst][a:b, parity::2] = unpack_bits1(plane[r + a:r + b])
        return out[0], out[1]

    def _links_slab(self, r: int, n: int):
        return self._links_slab_of(self._links_store, r, n)

    def links(self):
        """(v, h) full uint8 disorder link planes, or None without -J."""
        if self._links_store is None:
            return None
        if self.mesh is None:
            return self._links_slab(0, self.cfg.nrows)
        refuse_over_processes("the whole lattice's links (links())")
        parts = [self._links_slab_of(s, 0, self.cfg.local_rows)
                 for s in self._links_store]
        return tuple(gather_rows([p[i] for p in parts]) for i in (0, 1))

    def _up_rows_for(self, black, white):
        """Per-row up counts of the given storage planes, on the device: the
        backend's own reduction where it has one (popcount on bit1's and
        packed's words), else on the decoded planes."""
        be = self.backend

        def rows(k, b, w, tail):
            with profiling.span("count", b.device):
                if hasattr(be, "row_up_counts"):
                    return be.row_up_counts(b, w)
                return observables.row_up_counts(*be.decode(b, w))
        return self._per_slab(rows, black, white)

    def _up_total(self) -> int:
        """Up spins of the lattice (in a group, summed over its
        processes)."""
        rows = self._up_rows_for(self.black, self.white)
        with profiling.span("gather"):
            total = all_sum(rows.sum())
        with profiling.span("wait"):
            return int(total)

    def measure(self):
        with profiling.span("measure"):
            n_up = self._up_total()
        n_dn = self.cfg.nspins - n_up
        m = abs(n_up - n_dn) / (n_up + n_dn)
        out = {"step": self.step, "magnetization": m,
               "up": n_up, "down": n_dn}
        if self.cfg.field:
            # An external field breaks the +-m symmetry |m| relies on.
            out["m_signed"] = (n_up - n_dn) / (n_up + n_dn)
        return out

    def advance(self, nsteps: int):
        """Enqueue nsteps steps (returns before the card finishes)."""
        if nsteps <= 0:
            return
        with profiling.span("advance"):
            self.black, self.white = self._step_n(
                self.black, self.white, self._thr, self.step, nsteps)
        self.step += nsteps

    def block(self):
        for d in dict.fromkeys(self.mesh or [self.device]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def set_temperature(self, temp: float):
        """New thresholds: the u32 table, and the backend's accept (the
        greedy quench when T crosses 0, the k-bit thresholds of the
        bit-plane accepts), which every slab's next launch reads."""
        self.temp = float(temp)
        self._thr = ising.threshold_table(self.temp, self.cfg.field)
        self.backend.retune(self.temp, self.cfg.field)

    def set_field(self, field: float):
        """Change the uniform external field mid-run. SimConfig's
        validation fences the backend / rng pairs; the u32 table and the
        backend's accept (the bit-plane accept's field, the xla backend's
        full-table select) follow the new value."""
        field = float(field)
        if field == self.cfg.field:
            return
        self.cfg = dataclasses.replace(self.cfg, field=field)
        self._thr = ising.threshold_table(self.temp, field)
        self.backend.retune(self.temp, field)

    def energy_total(self) -> int:
        """Exact integer bond sum sum_bonds J_ij s_i s_j over the current
        state (H = -this). In replica mode it sums the full lattice's
        bonds, those across replica edges included, as the JAX package's
        does."""
        return int(all_sum(self._energy_rows().sum()))

    def _energy_rows_for(self, black, white, links=None,
                         row_chunk: int = 8192):
        """Per-row bond sums of the given storage planes, on the device, with
        the link store `links` (default: this run's): on the words where the
        backend can (bit1, with the packed link store under disorder), else
        streamed from storage in slabs of row_chunk rows with the link slabs.
        Over a mesh, slab by slab, each with the next slab's first row. A
        pure function of its inputs; parallel tempering takes every rung's
        before one transfer."""
        if links is None:
            links = self._links_store
        be = self.backend
        disordered = self._links_store is not None

        def rows(k, b, w, tail):
            lk = links[k] if isinstance(links, list) else links
            if not disordered and hasattr(be, "energy_rows"):
                return be.energy_rows(b, w, tail=tail)
            if (disordered and self._links_packed
                    and hasattr(be, "energy_rows_disordered")):
                return be.energy_rows_disordered(b, w, lk, tail=tail)
            tb, tw = (None, None) if tail is None else tail
            decode = lambda r, n: be.decode(
                observables._rows_after(b, r, n, tb),
                observables._rows_after(w, r, n, tw))
            links_rows = None
            if disordered:
                links_rows = lambda r, n: self._links_slab_of(lk, r, n)
            return observables.energy_rows_via(decode, b.shape[0],
                                               links_rows=links_rows,
                                               row_chunk=row_chunk)
        return self._per_slab(rows, black, white, tail_rows=1)

    def _energy_rows(self):
        """Per-row bond sums of the current state, on the device."""
        return self._energy_rows_for(self.black, self.white)

    def _overlap_neq_rows_with(self, other, row_chunk: int = 8192):
        """Per-row differing-spin counts against another Simulation's
        current state, on the device: on the words where both backends are
        of one type, with a word path (bit1, packed), and hold the same
        slabs; else through both states' decode, slab by slab."""
        be = self.backend
        if (type(other.backend) is type(be)
                and hasattr(be, "overlap_neq_rows")
                and type(self.black) is type(other.black)
                and (self.mesh is None or len(self.black) == len(other.black))):
            if self.mesh is None:
                return be.overlap_neq_rows(self.black, self.white,
                                           other.black, other.white)
            return torch.cat([
                be.overlap_neq_rows(b1, w1, b2.to(b1.device),
                                    w2.to(b1.device)).to(self.device)
                for b1, w1, b2, w2 in zip(self.black, self.white,
                                          other.black, other.white)])
        return observables.overlap_neq_rows_via(
            self._decode_rows, other._decode_rows, self.cfg.nrows,
            row_chunk=row_chunk)

    def overlap_with(self, other) -> float:
        """Edwards-Anderson overlap q = (1/N) sum_i s1_i s2_i with another
        Simulation's current state: 1 identical, -1 opposite. Exact integer
        XOR counts, finished in float here. The geometries must match; the
        backends and slab counts may differ (the decode path bridges their
        storage)."""
        if (self.cfg.nrows, self.cfg.ncols) != (other.cfg.nrows,
                                                other.cfg.ncols):
            raise ValueError("overlap needs matching lattice geometry")
        refuse_over_processes("the overlap")
        neq = int(self._overlap_neq_rows_with(other).sum())
        return 1.0 - 2.0 * neq / self.cfg.nspins

    def fourier_partials(self):
        """Exact (per-row, per-column) up-spin counts as int64 numpy: the
        integer partials of the Fourier magnetizations m(0) and
        m(k1 = 2 pi / L) along both axes. On bit1's words without a decode,
        else from decoded row slabs; over a mesh, each slab's column counts
        summed; one transfer. Full lattice only: replica tiles would mix in
        the line sums."""
        if self.cfg.xsl is not None or self.cfg.ysl is not None:
            raise ValueError("fourier_partials needs full-lattice mode "
                             "(replica tiles mix in the line sums); use "
                             "replica_magnetizations for tile statistics")
        refuse_over_processes("the Fourier partials")
        be = self.backend
        rows = self._up_rows_for(self.black, self.white)

        def cols(k, b, w, tail):
            if hasattr(be, "col_up_counts"):
                return be.col_up_counts(b, w)
            return observables.col_up_counts_via(
                lambda r, n: be.decode(b[r:r + n], w[r:r + n]), b.shape[0])
        cols = self._per_slab(cols, self.black, self.white,
                              join=lambda parts: torch.stack(parts).sum(0))
        both = torch.cat([rows, cols]).cpu().numpy()
        return both[:rows.numel()], both[rows.numel():]

    def replica_magnetizations(self):
        """|m| of each sub-lattice replica, row-major over the replica grid
        (observables.replica_magnetizations), slab by slab: replicas never
        cross a slab (ysl divides its height). In a group of processes each
        rank's replicas' int64 up counts take their places in the grid,
        which is summed over the group."""
        cfg = self.cfg
        if cfg.xsl is None:
            raise ValueError("replica_magnetizations needs replica mode "
                             "(cfg.xsl/ysl)")
        xsl, ysl = cfg.xsl, cfg.ysl
        if self.mesh is None:
            return observables.replica_magnetizations(*self.bits(), xsl, ysl)
        ups = torch.cat([observables.replica_up_counts(b, w, xsl, ysl)
                         .to(self.device) for b, w in self._decode_slabs()])
        grid = torch.zeros((cfg.nrows // ysl, cfg.ncols // xsl),
                           dtype=torch.int64, device=self.device)
        r0 = self.slab0 * cfg.local_rows // ysl
        grid[r0:r0 + ups.shape[0]] = ups
        return observables.replica_abs_m(all_sum(grid), xsl, ysl)

    def energy(self) -> float:
        """Internal energy per spin; a field adds its exact -h sum(s)."""
        e = -float(self.energy_total())
        h = self.cfg.field
        if h:
            e -= h * (2 * self._up_total() - self.cfg.nspins)
        return e / self.cfg.nspins

    def run(self, log=print):
        return run_loop(self, log=log)

    # -- event actions and files --------------------------------------------

    def _corr_path(self):
        return (f"corr_{self.cfg.nrows}x{self.cfg.ncols}"
                f"_T_{self.temp:f}_{self.cfg.seed}")

    def _storage_rows(self, r: int, n: int):
        """Storage of the wrapped rows [r, r+n), on self.device."""
        if self.mesh is None:
            return (observables._rows_wrap(self.black, r, n),
                    observables._rows_wrap(self.white, r, n))
        return (ring_rows(self.black, r, n, self.device),
                ring_rows(self.white, r, n, self.device))

    def _decode_rows(self, r: int, n: int):
        """Decoded compact planes of the wrapped rows [r, r+n)."""
        return self.backend.decode(*self._storage_rows(r, n))

    def _append_corr(self, it: int):
        """One -c line: c(d), d = 1..MAX_CORR_LEN, on the words where the
        backend can (bit1), else from rows decoded slab by slab; in replica
        mode inside the replicas, from the decoded planes. Over a mesh,
        each slab with the MAX_CORR_LEN rows after it."""
        be, cfg = self.backend, self.cfg
        if cfg.xsl is None:
            def rows(k, b, w, tail):
                if hasattr(be, "corr_rows"):
                    return be.corr_rows(b, w, MAX_CORR_LEN, tail=tail)
                tb, tw = (None, None) if tail is None else tail
                return observables.correlation_rows_via(
                    lambda r, n: be.decode(
                        observables._rows_after(b, r, n, tb),
                        observables._rows_after(w, r, n, tw)),
                    b.shape[0], MAX_CORR_LEN)
            tail_rows = MAX_CORR_LEN
        else:
            def rows(k, b, w, tail):
                return observables.correlation_row_sums(
                    *be.decode(b, w), MAX_CORR_LEN, cfg.xsl, cfg.ysl)
            tail_rows = 0
        rows = self._per_slab(rows, self.black, self.white, tail_rows)
        c = rows.cpu().numpy().sum(axis=1) / (2.0 * cfg.nspins)
        lio.append_corr_line(self._corr_path(), it, c)

    # Lattices of at least this many spins dump row chunk by row chunk, so
    # the decoded planes are never whole on the host. A class attribute, so
    # that a test can lower it.
    STREAM_DUMP_SPINS = 1 << 30

    def dump(self, name: str):
        """Write the lattice to `name` in the hex format: one file per slab
        over a mesh (lio.dump_lattice_sharded), streamed at or above
        STREAM_DUMP_SPINS spins (the same bytes), in one piece below. In a
        group of processes each rank writes the files of its own slabs,
        named by their global indices."""
        if self.mesh is not None:
            pairs = self._decode_slabs()
            lio.dump_lattice_sharded(name, [p[0] for p in pairs],
                                     [p[1] for p in pairs], fmt="hex",
                                     first=self.slab0)
        elif self.cfg.nspins >= self.STREAM_DUMP_SPINS:
            lio.dump_lattice_streamed(
                name, lambda r0, r1: self.backend.decode(self.black[r0:r1],
                                                         self.white[r0:r1]),
                self.cfg.nrows)
        else:
            lio.dump_lattice(name, *self.bits(), fmt="hex")

    def _dump(self, it: int):
        self.dump(f"lattice_{self.cfg.nrows}x{self.cfg.ncols}"
                  f"_T_{self.temp:f}_IT_{it:08d}.txt")

    def checkpoint(self, path: str):
        """Save the state, one row chunk at a time (over a mesh, a chunk's
        rows gathered from its slabs): bit1 shuffles its words straight
        into the file's bytes, the other backends decode a chunk and pack
        it on the device (the same bytes, at any slab count)."""
        from .checkpoint import save_checkpoint_streamed
        refuse_over_processes("the checkpoint")
        be = self.backend
        rows = lambda r0, r1: self._storage_rows(r0, r1 - r0)
        packed_rows = None
        first = self.black[0] if self.mesh else self.black
        if hasattr(be, "pack_storage_rows") and \
                be.storage_pack_supported(first):
            packed_rows = lambda r0, r1: be.pack_storage_rows(
                *rows(r0, r1), 0, r1 - r0)
        save_checkpoint_streamed(
            path, lambda r0, r1: be.decode(*rows(r0, r1)),
            self.cfg.nrows, self.cfg.ncols, step=self.step, temp=self.temp,
            cfg=self.cfg, packed_rows=packed_rows)

    @classmethod
    def from_checkpoint(cls, path: str, *, mesh=None, **overrides):
        """Resume a checkpoint (the port's or the JAX package's), possibly
        into another backend, another slab count (ndev=; default the
        file's) or onto the device that `device=` names (default cuda):
        each row chunk becomes the target backend's storage as it is read,
        then the storage is cut into the run's slabs."""
        from .checkpoint import load_checkpoint_state, read_checkpoint_meta
        refuse_over_processes("a resume from a checkpoint")
        device = overrides.get("device", "cuda")
        cfg = read_checkpoint_meta(path, device=device)["cfg"]
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        mesh = slab_devices(cfg, mesh)
        be = get_backend(cfg)
        (b, w), meta = load_checkpoint_state(
            path, be.encode, getattr(be, "encode_packed_rows", None),
            device=mesh[0] if mesh else cfg.device)
        return cls(cfg, storage=(b, w), step0=meta["step"],
                   temp=meta["temp"], mesh=mesh)


def run_loop(self, log=print):
    """The measurement loop: warmup, events on the -p / -e / -E schedule
    (each may append a -c line and dump the lattice, -o, inside the timed
    window as in the JAX package), early exit (-m), temperature ramp (-u),
    final report with flips/ns. Duck-typed over Simulation and
    cluster.SwendsenWang."""
    cfg = self.cfg
    t_unit = cfg.temperature

    if cfg.nwarmup:
        self.advance(cfg.nwarmup)
        self.block()

    events = set()
    if cfg.print_exp and cfg.exp_thinned:
        events.update(t for t in reference_exp_times(cfg.niters)
                      if t <= cfg.niters)
    elif cfg.print_exp:
        events.update(exponential_print_steps(cfg.niters))
    elif cfg.print_freq:
        events.update(range(cfg.print_freq, cfg.niters + 1,
                            cfg.print_freq))
    temp_events = set()
    if cfg.temp_freq:
        temp_events.update(range(cfg.temp_freq, cfg.niters + 1,
                                 cfg.temp_freq))
    all_events = sorted(events | temp_events | {cfg.niters})

    m0 = self.measure()
    log(f"Initial magnetization: {m0['magnetization']:9.6f}, "
        f"up_s: {m0['up']:12d}, dw_s: {m0['down']:12d}")
    series = [(0, m0["magnetization"])]

    self.block()
    t0 = time.perf_counter()
    # The span that flips/ns times, for a profiler trace (device_trace.py).
    with profiling.span("window"):
        base = self.step
        done = 0
        stopped_early = False
        for ev in all_events:
            self.advance(base + ev - self.step)
            done = ev
            if ev in events:
                self.block()
                mm = self.measure()
                series.append((ev, mm["magnetization"]))
                log(f"        magnetization: {mm['magnetization']:9.6f}, "
                    f"up_s: {mm['up']:12d}, dw_s: {mm['down']:12d} "
                    f"(iter: {ev:8d})")
                if cfg.corr_out:
                    self._append_corr(ev)
                if cfg.dump_lattice:
                    self._dump(ev)
                if cfg.tgt_magn is not None and \
                        abs(mm["magnetization"] - cfg.tgt_magn) \
                        < TGT_MAGN_MAX_DIFF:
                    stopped_early = True
                    break
            if ev in temp_events:
                new_t = max(MIN_TEMP, self.temp + cfg.temp_step)
                log(f"Changing temperature to {new_t:f}")
                self.set_temperature(new_t)
        self.block()
    elapsed = time.perf_counter() - t0

    mf = self.measure()
    log(f"Final   magnetization: {mf['magnetization']:9.6f}, "
        f"up_s: {mf['up']:12d}, dw_s: {mf['down']:12d} "
        f"(iter: {done:8d})")

    flips = cfg.nspins * done
    flips_ns = flips / (elapsed * 1e9) if elapsed > 0 else 0.0
    # Effective lattice traffic: per color phase read src + read dst +
    # write dst. SwendsenWang has no backend: one byte per spin.
    bps = getattr(getattr(self, "backend", None), "bytes_per_spin", 1.0)
    bw = flips_ns * 3.0 * bps
    log(f"Kernel execution time for {done} update steps: "
        f"{elapsed * 1e3:E} ms, {flips_ns:.2f} flips/ns "
        f"(BW: {bw:.2f} GB/s)")
    return {"steps": done, "elapsed_s": elapsed, "flips_ns": flips_ns,
            "bw_gbs": bw, "magnetization": mf["magnetization"],
            "stopped_early": stopped_early, "series": series,
            "temp_final": self.temp, "alpha_unit": t_unit}
