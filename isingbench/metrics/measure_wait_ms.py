"""Host time the measurement blocks for its answer (the program's `wait`
span around the int() that waits for the devices), mean over the
measurements of the traced slice."""

from isingbench import program_spans


def read(run):
    return program_spans.mean(
        (s.host_s for s in program_spans.named("wait") or ()), 1e3)
