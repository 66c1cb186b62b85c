"""Profiling and tracing helpers.

Counterpart of :mod:`geomloss_tpu.utils.profiling`: :func:`trace` wraps
``torch.profiler`` (host and, where there is one, CUDA activity) and
writes a Chrome trace under ``log_dir``; :class:`Timer` reads the wall
clock after the device has finished the work it times.

Usage::

    from geomloss_tpu_torch.utils.profiling import trace

    with trace("traces/geomloss"):
        loss = SamplesLoss("sinkhorn")(x, y)
        loss.item()
"""

import contextlib
import os
import time

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(log_dir, create_perfetto_link=False):
    """Context manager: capture a ``torch.profiler`` trace of the block and
    write it as ``trace.json`` under ``log_dir`` (created if needed).

    View it in ``chrome://tracing`` or ui.perfetto.dev.
    ``create_perfetto_link`` is accepted for the JAX package's signature
    and ignored.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _tensors(v)


class Timer:
    """Wall-clock timer that waits for the device work it times.

    ``stop(result)`` synchronizes the CUDA devices of the tensors in
    ``result`` (a tensor or a nested tuple / list / dict of them) before it
    reads the clock.
    """

    def __init__(self):
        self._t0 = None
        self.elapsed = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None):
        for dev in {t.device for t in _tensors(result) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
