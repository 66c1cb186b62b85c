"""``kernels.energy_roofline``: the least time of a call's pair work for
the energy distance (:mod:`benchmark.metrics._energy_work`, counted from
the cell's sizes) over the device's busy time a call, in %. The
denominator is all device time, so work moved into other operations
cannot raise it. Nothing to read for another loss or on a card without
figures."""

from benchmark.metrics import _energy_work


def read(trace):
    if trace.call.get("loss") != "energy" or not trace.calls:
        return None
    n, m, d = trace.sizes
    least = _energy_work.least_seconds(n, m, d, trace.card, trace.sm_clock_hz)
    busy = trace.busy_s() / trace.calls
    if least is None or busy <= 0:
        return None
    return 100.0 * least / busy
