"""``device.idle_share``: the share of the traced window (host clock) in
which no operation ran on the device, in %."""


def read(trace):
    if not trace.window_s or not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
