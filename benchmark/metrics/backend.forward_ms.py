"""``backend.forward_ms``: host-clock ms of ``loss(x, y)`` up to a
synchronize, a call: the front end, the backend's prologue, its ε loop and
the last extrapolation's forward pass."""


def read(trace):
    if not trace.forward_s:
        return None
    return 1e3 * sum(trace.forward_s) / len(trace.forward_s)
