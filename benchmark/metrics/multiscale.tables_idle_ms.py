"""``multiscale.tables_idle_ms``: device-idle ms a call while the program
built its truncation tables (``multiscale.tables`` spans), host reads of
their widths included."""

from benchmark.metrics._program_trace import idle_ms_per_call


def read(trace):
    return idle_ms_per_call(trace, {"multiscale.tables"})
