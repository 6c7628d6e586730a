"""Host time of the program's set-up spans (`setup.kernels`: the kernels'
build or load; `setup.lattice`: the initial state, a slab at a time;
`setup.stepper`), those not inside another set-up span, summed over the
run."""

from isingbench import program_spans

PARTS = ("setup.kernels", "setup.lattice", "setup.stepper")


def read(run):
    spans = [s for name in PARTS for s in program_spans.named(name) or ()]
    outer = [s for s in spans
             if s.parent is None or not s.parent.name.startswith("setup.")]
    return sum(s.host_s for s in outer) if outer else None
