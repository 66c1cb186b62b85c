"""``kernels.gpairs_per_call``: point pairs the port's kernel launches
covered, a call, in 1e9 (``kernels.pairs``, counted at each launch: rows
times columns, the triangle of the symmetric step, or kept tiles times
the tiles' sides)."""

from benchmark.metrics._program_trace import recorded


def read(trace):
    rec = recorded()
    if rec is None or not trace.calls:
        return None
    return rec[1].get("kernels.pairs", 0) / trace.calls / 1e9
