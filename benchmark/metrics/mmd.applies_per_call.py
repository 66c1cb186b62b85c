"""``mmd.applies_per_call``: the streaming MMD matvec's applies a call,
the forwards (``matvec.forwards``) and the applies its backward launches
(``matvec.backward_applies``), counted by the program where it launches
them (``ops/softmin.py::_GibbsMatvec``). Nothing to read from a program
that does not count them."""

from benchmark.metrics._program_trace import recorded

COUNTERS = ("matvec.forwards", "matvec.backward_applies")


def read(trace):
    rec = recorded()
    if rec is None or not trace.calls or not any(k in rec[1] for k in COUNTERS):
        return None
    return sum(rec[1].get(k, 0) for k in COUNTERS) / trace.calls
