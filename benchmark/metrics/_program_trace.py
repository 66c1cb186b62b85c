"""What the program recorded of a traced window, for the readers of the
per-layer metrics that read inside the program.

The program (``geomloss_tpu_torch.utils.profiling``) records its own spans
and counts while a ``torch.profiler`` session records, as the traced
window does: host-clock spans ``(name, start_ns, end_ns, ...)`` stamped
with ``time.time_ns()``, the clock of the profiler's device events, and
counters such as ``host.reads`` or ``kernels.pairs``. A program without
that recorder, or a window in which it recorded nothing, gives ``None``.
"""


def recorded():
    """``(spans, counts)`` of the window, or ``None``."""
    try:
        from geomloss_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans, counts = getattr(profiling, "spans", None), getattr(profiling, "counts", None)
    if spans is None or counts is None:
        return None
    window = spans()
    if not window:
        return None
    return window, counts()


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def idle_ns(intervals, events):
    """Nanoseconds of the union of ``intervals`` in which no device event
    ``(name, start_ns, end_ns)`` ran: each interval's length less the
    union of the events inside it."""
    busy = merged((s, e) for _, s, e in events)
    total, j = 0, 0
    for s, e in merged(intervals):
        covered = 0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        total += (e - s) - covered
    return total


def idle_ms_per_call(trace, names=None):
    """Device-idle ms a call while a span (named in ``names``, or any) was
    open on the host, or ``None``."""
    rec = recorded()
    if rec is None or not trace.calls:
        return None
    spans = [(s.start_ns, s.end_ns) for s in rec[0] if names is None or s.name in names]
    return idle_ns(spans, trace.events) / 1e6 / trace.calls
