"""``ops.torch_kernel_ms``: device ms a call of every operation that is not
one of the port's own ``__global__`` kernels: PyTorch's sorts, table
building and elementwise work, copies and sets."""


def read(trace):
    if not trace.calls:
        return None
    ms = 1e3 * trace.device_s(lambda name: not trace.is_port(name)) / trace.calls
    return ms if ms > 0 else None
