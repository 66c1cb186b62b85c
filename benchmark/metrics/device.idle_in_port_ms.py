"""``device.idle_in_port_ms``: device-idle ms a call while some span of the
program was open on the host (its own phases, forward and backward); the
rest of ``device.idle_share``'s idle lies outside the program (the
caller's loop, autograd's glue)."""

from benchmark.metrics._program_trace import idle_ms_per_call


def read(trace):
    return idle_ms_per_call(trace)
