"""``backend.backward_ms``: host-clock ms of ``torch.autograd.grad(v, x)``
up to a synchronize, a call: the gradient's apply."""


def read(trace):
    if not trace.backward_s:
        return None
    return 1e3 * sum(trace.backward_s) / len(trace.backward_s)
