"""The program's own record of spans (ising_tpu_torch/utils/profiling.py),
for the readers of the per-layer metrics that look inside the program's
calls. Tracing turns on while the harness's profiler records, so after a
`--trace 1` run the record holds the traced slice's spans and the set-up
spans (which the program keeps in every run). A program that keeps no
such record gives None, and so do its readers: their metric is left out
of the result line."""


def named(name: str):
    """The finished spans called `name`, or None where the program keeps
    no record of spans."""
    try:
        from ising_tpu_torch.utils import profiling
    except ImportError:
        return None
    record = getattr(profiling, "spans", None)
    if record is None:
        return None
    return [s for s in record() if s.name == name]


def mean(values, scale: float = 1.0):
    """scale times the mean of values, None where there are none."""
    values = [v for v in values or () if v is not None]
    return scale * sum(values) / len(values) if values else None
