"""``host.launches_per_call``: device operations (kernels, copies, sets)
the profiler recorded, a call."""


def read(trace):
    if not trace.calls or not trace.events:
        return None
    return len(trace.events) / trace.calls
