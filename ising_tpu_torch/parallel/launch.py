"""Run a function in a group of local processes under a deadline.

``run_group(fn, size, ...)`` starts `size` processes (the spawn method),
each of which joins one torch.distributed group through
mesh.initialize_multihost with a ``file://`` rendezvous (no port to pick)
and calls ``fn(rank, size, *args)``. It returns the ranks' results in
rank order, and raises if a rank fails, dies or outlives the deadline,
after killing every process still alive: no caller can hang on a group.
`fn` and its arguments are pickled, so `fn` is a module-level function.
This is how the tests run the row slabs over 2 and 4 processes on the CPU
(gloo) and chip_smoke.py runs them over ranks on the card.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from datetime import timedelta

# Seconds the other ranks get to report after one failed, and a finished
# process to exit, before they are killed.
FAILED_GRACE_S = 10.0


def _rank_main(fn, rank, size, init_file, device, backend, timeout_s, args,
               results):
    import torch.distributed as dist

    from .mesh import initialize_multihost
    try:
        kw = {} if backend is None else {"backend": backend}
        initialize_multihost(device=device, init_method=f"file://{init_file}",
                             world_size=size, rank=rank,
                             timeout=timedelta(seconds=timeout_s), **kw)
        results.put((rank, True, fn(rank, size, *args)))
    except Exception:   # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(fn, size: int, args=(), *, init_file, device="cpu",
              backend=None, timeout_s: float = 120.0):
    """[fn(rank, size, *args) for each rank] of a group of `size` processes
    on `device`, in which "{rank}" stands for the rank ("cuda:{rank}": a
    GPU a rank), the backend as initialize_multihost chooses unless given,
    rendezvous through the file `init_file` (absent or empty), everything
    done within timeout_s seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, size, str(init_file),
                               str(device).format(rank=r),
                               backend, timeout_s, args, results))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failed = {}, {}
    grace = deadline
    try:
        while len(got) + len(failed) < size:
            if failed and time.monotonic() > grace:
                break   # the others wait on the failed rank
            try:
                rank, ok, out = results.get(timeout=1.0)
                (got if ok else failed)[rank] = out
                if not ok and len(failed) == 1:
                    grace = time.monotonic() + FAILED_GRACE_S
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in got
                    and r not in failed]
            if dead:
                try:    # a result sent just before the exit
                    rank, ok, out = results.get(timeout=1.0)
                    (got if ok else failed)[rank] = out
                except queue.Empty:
                    failed.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode}" for r in dead})
                    grace = time.monotonic() + FAILED_GRACE_S
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"a group of {size} processes ran past {timeout_s} s; "
                    f"ranks {sorted(set(range(size)) - set(got))} had not "
                    "finished")
    finally:
        # A finished group's processes exit on their own; a late one's are
        # stuck in a collective.
        end = time.monotonic() + (FAILED_GRACE_S if len(got) == size
                                  else 0.5)
        for p in procs:
            p.join(timeout=max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        late = sorted(set(range(size)) - set(got) - set(failed))
        raise RuntimeError("".join(f"\n--- rank {r} ---\n{msg}"
                                   for r, msg in sorted(failed.items()))
                           + (f"\nranks {late} did not finish" if late
                              else ""))
    return [got[r] for r in range(size)]
