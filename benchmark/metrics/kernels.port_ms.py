"""``kernels.port_ms``: device ms a call of the port's own kernels, known by
the ``__global__`` names of its CUDA sources."""


def read(trace):
    if not trace.calls:
        return None
    ms = 1e3 * trace.device_s(trace.is_port) / trace.calls
    return ms if ms > 0 else None
