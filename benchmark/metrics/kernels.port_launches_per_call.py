"""``kernels.port_launches_per_call``: launches of the port's own kernels a
call, counted by the program at its one launch point
(``kernels.launches.<wrapper>``)."""

from benchmark.metrics._program_trace import recorded


def read(trace):
    rec = recorded()
    if rec is None or not trace.calls:
        return None
    return sum(n for name, n in rec[1].items() if name.startswith("kernels.launches.")) / trace.calls
