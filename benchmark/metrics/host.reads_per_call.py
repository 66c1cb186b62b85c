"""``host.reads_per_call``: reads of a device value to the host a call,
counted by the program where it reads (``host.reads``)."""

from benchmark.metrics._program_trace import recorded


def read(trace):
    rec = recorded()
    if rec is None or not trace.calls:
        return None
    return rec[1].get("host.reads", 0) / trace.calls
