"""Simulation.replica_magnetizations in two halves, for a mix that
dispatches its measurements ahead: the same program calls as the entry
makes on one device, without its wait for the answer.

issue(sim) enqueues the decode of the lattice and the tile sums and
returns the replicas' int64 up counts on the device; finish(sim, ups)
gives the entry's answer, each replica's |m|, from their host copy."""

from ising_tpu_torch import observables


def issue(sim):
    if sim.mesh is not None:
        raise ValueError("replica_magnetizations is dispatched ahead on "
                         "one device only")
    return observables.replica_up_counts(*sim.bits(), sim.cfg.xsl,
                                         sim.cfg.ysl)


def finish(sim, ups):
    return observables.replica_abs_m(ups, sim.cfg.xsl, sim.cfg.ysl)
