"""``mmd.gpairs_per_call``: point pairs of the streaming MMD matvec's
applies a call, in 1e9 (``matvec.pairs``: rows times columns of every
apply that ``ops/softmin.py::_GibbsMatvec`` launches, forward and
backward). Nothing to read from a program that does not count them."""

from benchmark.metrics._program_trace import recorded


def read(trace):
    rec = recorded()
    if rec is None or not trace.calls or "matvec.pairs" not in rec[1]:
        return None
    return rec[1]["matvec.pairs"] / trace.calls / 1e9
