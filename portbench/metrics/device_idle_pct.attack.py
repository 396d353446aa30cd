"""The device's idle share of an attack batch, in percent: one less the busy
time of a traced batch (the union of its device operations' intervals) over
the window's mean wall time of a batch (measured without the profiler).
Nothing where the trace holds no device operation."""


def read(r):
    if not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.units / r.unit_s)
