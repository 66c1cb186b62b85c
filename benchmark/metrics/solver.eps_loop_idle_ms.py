"""``solver.eps_loop_idle_ms``: device-idle ms a call while the program's
ε loop (``solver.eps_loop`` spans) ran on the host: the time the host
takes to launch the loop's kernels."""

from benchmark.metrics._program_trace import idle_ms_per_call


def read(trace):
    return idle_ms_per_call(trace, {"solver.eps_loop"})
