"""The single-device step loop of the port.

The ndev == 1 branch of ``ising_tpu/parallel/sharded.py``, without
collectives: each step updates black against white, then white against
black, with the periodic wrap rows taken from the other plane. The loop
runs on the host; each color phase is one kernel launch of the backend
(bit1_sweep, packed_sweep, dense_sweep or mxu_sweep; plain torch on xla).
Where the backend's ``fusable`` says so (packed under ISING_TPU_FUSED=1|2,
sharded.py:57-59), a step is one ``update_step`` call instead: both colors
in one launch, returning new planes.
"""

from __future__ import annotations

from ..config import not_ported
from ..constants import BLACK, WHITE
from ..rng import MASK


def make_stepper(cfg, backend, jplanes=None):
    """step_n(black, white, thr10, step0, n) -> (black, white) after n
    steps; the two-call path updates the planes in place, the fused one
    returns new planes. jplanes: the disorder of driver.build_disorder as
    (black's, white's) J planes; in split-link mode both are the one link
    store."""
    if cfg.ndev != 1:
        raise not_ported("more than one device", 7)
    jb, jw = (None, None) if jplanes is None else jplanes
    fused = (jplanes is None and hasattr(backend, "fusable")
             and backend.fusable(cfg.nrows))

    def step_n(b, w, thr10, step0, n):
        for i in range(n):
            step = (int(step0) + i) & MASK
            if fused:
                b, w = backend.update_step(b, w, thr10=thr10, step=step)
                continue
            b = backend.update_color(b, w, color=BLACK, thr10=thr10,
                                     step=step, row0=0, src_up=w[-1:],
                                     src_dn=w[:1], jplanes=jb)
            w = backend.update_color(w, b, color=WHITE, thr10=thr10,
                                     step=step, row0=0, src_up=b[-1:],
                                     src_dn=b[:1], jplanes=jw)
        return b, w

    return step_n
