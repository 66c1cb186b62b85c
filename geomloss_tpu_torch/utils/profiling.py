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

The recorder
------------

The program marks its own phases and counts its own work here, and
nowhere else:

* :func:`span` marks a phase (``with span("multiscale.sort"): ...``, or
  :func:`spanned` around a whole function);
* :func:`count` adds to a counter (``count("host.reads")``).

**Recording is on while a** ``torch.profiler`` **session records**, with
whatever activities: :func:`trace`, or a profiler of the caller's own.
Outside one a span is one flag check, and a count of a host integer one
addition to its lifetime total (:data:`totals`; the kernel launch counters
of :mod:`..ops.cuda_kernels` and :mod:`..ops.cuda_block_sparse` are views
of it). While recording:

* each span appends ``(name, start_ns, end_ns, parent, call_id, thread,
  seq)`` to a buffer (:func:`spans`), stamped with ``time.time_ns()``, the
  Unix-epoch clock on which ``torch.profiler`` puts its host and device
  events, and enters ``torch.profiler.record_function(name)``, so that the
  span shows in the profiler's own trace too;
* each count is also added to the window's counts (:func:`counts`) under
  the call id of the innermost open span. A 0-d device tensor is taken
  only then: it is kept as it is, and the window's device counts are
  summed on the device and read once, when :func:`counts` reads them.

Call ids: a span opened with ``new_call=True`` (``loss``, the root of a
``SamplesLoss`` call) takes a new one; any other span takes its parent's.
The program's autograd Functions (:func:`autograd_spans`) keep the id of
the forward pass and give it to their ``backward.<Function>`` span, which
runs on autograd's device thread for CUDA tensors.

The buffer keeps the last :data:`MAX_SPANS` spans; older ones are dropped
and counted (:func:`dropped`). :func:`reset` clears the recording.
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from collections.abc import Mapping
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "trace",
    "Timer",
    "Span",
    "span",
    "spanned",
    "count",
    "recording",
    "spans",
    "counts",
    "dropped",
    "reset",
    "totals",
    "TotalsView",
    "kept_tiles",
    "table_sum",
    "count_table",
    "autograd_spans",
    "MAX_SPANS",
]


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


# ==============================================================================
#  The recorder
# ==============================================================================

#: Spans the buffer keeps; past it the oldest are dropped (and counted).
MAX_SPANS = 1 << 20


class Span(NamedTuple):
    """A recorded span: host-clock ``[start_ns, end_ns]`` on the Unix epoch,
    the ``seq`` of the span it was opened in on the same thread (``None``
    at the top), the call id (``None`` outside a call), the thread's
    identifier, and its own ``seq``."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call_id: Optional[int]
    thread: int
    seq: int


#: Lifetime totals of the host integers counted, recording or not.
totals = {}

_spans = collections.deque()
_dropped = 0
#: The window's host counts by ``(name, call_id)``, and its device counts
#: as ``(name, call_id, tensor, scale)``.
_window = {}
_window_dev = []
#: Device sums computed once per table tensor while recording (:func:`table_sum`).
_memo = WeakIdKeyDictionary()
_lock = threading.Lock()
_local = threading.local()
_seq = itertools.count()
_calls = itertools.count(1)
_OFF = contextlib.nullcontext()


def recording():
    """Whether a ``torch.profiler`` session records (a module flag of
    ``torch.autograd.profiler``, which every thread sees)."""
    return _autograd_profiler._is_profiler_enabled


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current_call():
    stack = getattr(_local, "stack", None)
    return stack[-1].call_id if stack else None


class _Span:
    __slots__ = ("name", "call_id", "parent", "seq", "start", "rf")

    def __init__(self, name, new_call, call_id):
        self.name = name
        self.call_id = next(_calls) if new_call else call_id

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        if self.call_id is None and top is not None:
            self.call_id = top.call_id
        self.parent = None if top is None else top.seq
        self.seq = next(_seq)
        stack.append(self)
        self.start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        with _lock:
            if len(_spans) >= MAX_SPANS:
                _spans.popleft()
                _dropped += 1
            _spans.append(Span(self.name, self.start, end, self.parent, self.call_id, threading.get_ident(),
                               self.seq))
        return False


def span(name, new_call=False, call_id=None):
    """Context manager marking a phase of the program, recorded while a
    ``torch.profiler`` session records (a no-op otherwise). ``new_call``
    opens a new call id; ``call_id`` gives one (a backward pass's); else
    the span takes its parent's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, new_call, call_id)


def spanned(name, new_call=False):
    """Decorator: the function runs in a span ``name`` (:func:`span`)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name, new_call):
                return fn(*args, **kwargs)

        return run

    return wrap


def count(name, n=1, scale=1):
    """Adds ``n * scale`` to the counter ``name``.

    A host integer goes to the lifetime total (:data:`totals`) and, while
    recording, to the window's counts under the current call id. A 0-d
    device tensor ``n`` (an integer count) is taken only while recording,
    kept unread, and summed when :func:`counts` reads the window: the
    caller builds it only while :func:`recording` holds, so that no device
    work runs otherwise.
    """
    if isinstance(n, torch.Tensor):
        if _autograd_profiler._is_profiler_enabled:
            with _lock:
                _window_dev.append((name, _current_call(), n, scale))
                if len(_window_dev) >= MAX_SPANS:
                    _fold_device_counts()
        return
    n *= scale
    key = (name, _current_call()) if _autograd_profiler._is_profiler_enabled else None
    with _lock:
        totals[name] = totals.get(name, 0) + n
        if key is not None:
            _window[key] = _window.get(key, 0) + n


def _fold_device_counts():
    """Sums the window's device counts of each key on the device, so that
    the list stays bounded (under ``_lock``)."""
    groups = {}
    for name, call, t, scale in _window_dev:
        groups.setdefault((name, call, t.device), []).append(t.reshape(()).double() * scale)
    _window_dev[:] = [(name, call, torch.stack(ts).sum(), 1) for (name, call, _), ts in groups.items()]


def spans():
    """The recorded spans (:class:`Span`), in the order they closed."""
    with _lock:
        return list(_spans)


def dropped():
    """Spans dropped from the buffer since the last :func:`reset`."""
    return _dropped


def counts(by_call=False):
    """The window's counts: ``{name: total}``, or with ``by_call``
    ``{(name, call_id): total}``. Device counts are summed on their device
    and read in one transfer per device."""
    with _lock:
        host, dev = dict(_window), list(_window_dev)
    out = {}
    for (name, call), n in host.items():
        key = (name, call) if by_call else name
        out[key] = out.get(key, 0) + n
    by_device = {}
    for entry in dev:
        by_device.setdefault(entry[2].device, []).append(entry)
    for device, entries in by_device.items():
        vals = torch.stack([t.reshape(()).double() for _, _, t, _ in entries])
        scales = torch.tensor([float(s) for _, _, _, s in entries], dtype=torch.float64, device=device)
        for (name, call, _, _), v in zip(entries, (vals * scales).tolist()):
            key = (name, call) if by_call else name
            out[key] = out.get(key, 0) + int(round(v))
    return out


def reset():
    """Clears the recorded spans, the window's counts and the per-table sums
    (the lifetime totals stay)."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
        _window.clear()
        _window_dev.clear()
        _memo.clear()


class TotalsView(Mapping):
    """The lifetime totals of the counters ``prefix + name``, ``name`` in
    ``names``, as a read-only mapping by ``name`` (the kernel launch
    counters); :meth:`reset` sets them to zero."""

    def __init__(self, prefix, names):
        self.prefix = prefix
        self.names = tuple(names)

    def __getitem__(self, name):
        if name not in self.names:
            raise KeyError(name)
        return totals.get(self.prefix + name, 0)

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)

    def __repr__(self):
        return repr(dict(self))

    def reset(self):
        with _lock:
            for name in self.names:
                totals[self.prefix + name] = 0


# ------------------------------------------------------------------------------
#  Counts of truncation tables (device sums, while recording)
# ------------------------------------------------------------------------------


def table_sum(table, tag, fn):
    """``fn()``, a 0-d device tensor, computed once per tensor ``table`` and
    ``tag`` and kept beside it (until :func:`reset`): the kernels that read
    one table many times count its work without a reduction each. Call it
    only while :func:`recording` holds."""
    memo = _memo.get(table)
    if memo is None:
        memo = _memo[table] = {}
    if tag not in memo:
        memo[tag] = fn()
    return memo[tag]


def kept_tiles(cnt, width=None):
    """The kept tiles of a table's counts ``cnt`` (each clamped at
    ``width``), a 0-d device tensor computed once per ``cnt``
    (:func:`table_sum`)."""
    return table_sum(cnt, ("kept", width), lambda: (cnt if width is None else torch.clamp(cnt, max=width)).sum())


def count_table(cnt, width=None):
    """A truncation table built, counted while recording: its row tiles
    (``tables.row_tiles``) and its kept tiles (``tables.kept_tiles``, a
    device sum)."""
    if _autograd_profiler._is_profiler_enabled:
        count("tables.row_tiles", cnt.shape[0])
        count("tables.kept_tiles", kept_tiles(cnt, width))


# ------------------------------------------------------------------------------
#  Autograd Functions
# ------------------------------------------------------------------------------


def autograd_spans(cls):
    """Class decorator of a ``torch.autograd.Function``: its forward keeps
    the call id of the open span on ``ctx``, and its backward runs in a
    span ``backward.<name>`` (the class name without leading
    underscores) under that id."""
    forward, backward = cls.forward, cls.backward
    name = "backward." + cls.__name__.lstrip("_")

    def traced_forward(ctx, *args):
        ctx.call_id = _current_call()
        return forward(ctx, *args)

    def traced_backward(ctx, *grads):
        with span(name, call_id=ctx.call_id):
            return backward(ctx, *grads)

    cls.forward = staticmethod(traced_forward)
    cls.backward = staticmethod(traced_backward)
    return cls
