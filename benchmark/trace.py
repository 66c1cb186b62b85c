"""What a traced run hands the per-layer metrics' readers.

The traced window runs under ``torch.profiler`` with the device's activity
only (kernels, copies and sets: CUPTI records, no host op events), and the
harness's own host-clock spans around each call's forward and backward
pass. :class:`Trace` holds both, the cell's call and the card's figures.
"""

import re
from pathlib import Path

#: ``__global__`` functions of a CUDA source, templated or not.
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", re.S)


def port_kernel_names(csrc):
    """The ``__global__`` names of every ``.cu`` and ``.cuh`` file under
    ``csrc``, read as text (a kernel added later is counted too)."""
    names = set()
    for path in sorted(Path(csrc).glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def kernel_base_name(name):
    """The function name of a device event's name: ``void (anonymous
    namespace)::tiles_step_kernel<2, true>(float4 const*, ...)`` ->
    ``tiles_step_kernel``; ``Memcpy DtoD (Device -> Device)`` -> ``DtoD``."""
    s = name.replace("(anonymous namespace)::", "")
    cut = min([i for i in (s.find("("), s.find("<")) if i >= 0], default=len(s))
    head = s[:cut].split()
    return head[-1].split("::")[-1] if head else (name or "unnamed")


def device_events(prof):
    """``(name, start_ns, end_ns)`` of every device activity a
    ``torch.profiler.profile`` recorded, sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def union_ns(events):
    """The length of the union of the events' intervals."""
    total, end = 0, None
    for _, s, e in events:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(events, top=10):
    """The longest idle stretches between device activities, summed by the
    pair of operations around them (``after -> before``, by function
    name): what the host prepared while the card waited."""
    gaps, end, last = {}, None, None
    for name, s, e in events:
        if end is not None and s > end:
            key = f"{kernel_base_name(last)} -> {kernel_base_name(name)}"
            gaps[key] = gaps.get(key, 0) + (s - end)
        if end is None or e > end:
            end, last = e, name
    return [[k, v / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(events, top=10):
    """The device operations that took the most time, by function name."""
    t = {}
    for name, s, e in events:
        k = kernel_base_name(name)
        t[k] = t.get(k, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(t.items(), key=lambda kv: -kv[1])[:top]]


class Trace:
    """A traced window: ``calls`` loss + gradient calls in ``window_s``
    seconds of host clock, their ``forward_s`` / ``backward_s`` spans, the
    device's ``events`` (``(name, start_ns, end_ns)``), the names of the
    port's own kernels, the call and cloud sizes, the card's name and its
    highest SM clock (Hz)."""

    def __init__(self, calls, window_s, forward_s, backward_s, events, port_kernels, call, sizes, card,
                 sm_clock_hz):
        self.calls = calls
        self.window_s = window_s
        self.forward_s = forward_s
        self.backward_s = backward_s
        self.events = events
        self.port_kernels = port_kernels
        self.call = call
        self.sizes = sizes
        self.card = card
        self.sm_clock_hz = sm_clock_hz

    def is_port(self, name):
        return kernel_base_name(name) in self.port_kernels

    def busy_s(self):
        """Seconds in which some operation ran on the device."""
        return union_ns(self.events) / 1e9

    def device_s(self, which=None):
        """Summed device seconds of the events ``which(name)`` selects."""
        return sum(e - s for name, s, e in self.events if which is None or which(name)) / 1e9
