"""``kernels.online_roofline``: the least time of a call's pair work on the
online route (:mod:`benchmark.roofline`, counted from the call's
parameters) over the device's busy time a call, in %. The denominator is
all device time, so work moved into other operations cannot raise it.
Nothing to read on another route or on a card without figures."""

from benchmark import roofline


def read(trace):
    if trace.call.get("backend") != "online" or not trace.calls:
        return None
    n, m, d = trace.sizes
    exps, nbytes = roofline.online_work(n, m, d, trace.call)
    least = roofline.least_seconds(exps, nbytes, trace.card, trace.sm_clock_hz)
    busy = trace.busy_s() / trace.calls
    if least is None or busy <= 0:
        return None
    return 100.0 * least / busy
