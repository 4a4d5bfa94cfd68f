"""Profiling and tracing helpers (the JAX package's ``utils/profiling.py``).

The reference's only tracing is per-call wall-clock printouts
(gpu_image_processing.rs:396-397, web/main.ts:781, raw_photo_forge.py:1891).
Here: a barrier on the devices of a result, a device-time measurement on
CUDA events, and ``span``, the named host spans the program opens at its
layer boundaries (``editor.*``, ``develop.*``, ``open.*``). A span costs a
flag check when nothing listens; under ``torch.profiler`` it is an event
of the profiler's trace, on the clock of the card's kernels; under
``span_log`` it is a record of host nanoseconds.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch


def _tensors(x):
    """The tensors of a nested tuple / list / dict."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def fetch_sync(x):
    """Wait until the work producing every tensor of ``x`` (a tensor or a
    nested tuple / list / dict) is done on its device: one
    ``torch.cuda.synchronize`` per CUDA device; CPU tensors need nothing.
    Returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class _Clock:
    """Elapsed seconds of a block of work: CUDA events on ``device``'s
    current stream for a card, the host clock (after the work) otherwise."""

    def __init__(self, device):
        self.cuda = device is not None and device.type == "cuda"
        self.device = device

    def run(self, work):
        if self.cuda:
            with torch.cuda.device(self.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                work()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fetch_sync(work())
        return time.perf_counter() - t0


def _device_of(*xs):
    """The CUDA device of the first CUDA tensor among ``xs``, else None."""
    for x in xs:
        for t in _tensors(x):
            if t.device.type == "cuda":
                return t.device
    return None


def device_time(fn, *args, iters: int = 10, chain=None,
                min_window: float = 0.03, max_iters: int = 16384) -> float:
    """Median per-call time of ``fn(*args)`` in seconds (the JAX function's
    unit), on CUDA events when the arguments or the result live on a card,
    on the host clock otherwise.

    When ``chain`` is given — a function (i, last_out, args) -> new args —
    K calls are chained data-dependently and timed by difference quotient
    (T(K+1) - T(1)) / K, which excludes the fixed cost of a window. K grows
    geometrically until the window exceeds ``min_window`` seconds (or K
    reaches ``max_iters``), so a sub-millisecond kernel gives a real number
    instead of launch jitter. Raises instead of returning a time that is
    not positive. Without ``chain`` each call is timed alone ``iters``
    times after one warm-up call."""
    out = fn(*args)  # warm-up (and builds)
    clock = _Clock(_device_of(args, out))
    fetch_sync(out)
    if chain is None:
        return float(np.median([clock.run(lambda: fn(*args))
                                for _ in range(iters)]))

    def run(k):
        def work():
            a = args
            for i in range(k):
                a = chain(i, fn(*a), a)
            return a

        return clock.run(work)

    k = max(2, iters)
    while True:
        t1 = min(run(1) for _ in range(3))
        tk = min(run(k + 1) for _ in range(3))
        window = tk - t1
        if window >= min_window or k >= max_iters:
            break
        k = min(k * 4, max_iters)
    if window <= 0:
        raise RuntimeError(
            f"device_time: non-positive window {window * 1e3:.3f} ms at "
            f"K={k}; the call is below the measurable floor — raise max_iters")
    return window / k


# The profiler's event for a span: a FUNCTION-scope record function, an
# event of the trace on the profiler's clock that, unlike a user annotation
# (``torch.profiler.record_function``), the profiler does not project onto
# the card's timeline as a range of device work.
_TRACE_EVENT = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_LOG: list | None = None     # the open span log, or None


class _Stack(threading.local):
    """The names of the spans open on this thread, innermost last."""

    def __init__(self):
        self.names = []


_STACK = _Stack()


class _Span:
    __slots__ = ("name", "event", "log", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.event = None
        if torch.autograd._profiler_enabled():
            self.event = _TRACE_EVENT(self.name)
            self.event.__enter__()
        self.log = _LOG
        if self.log is not None:
            stack = _STACK.names
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
            self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        if self.log is not None:
            end = time.perf_counter_ns()
            _STACK.names.pop()
            self.log.append((self.name, self.parent, self.start, end))
        if self.event is not None:
            self.event.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager around a block of host work named ``name``. With
    neither a profiler running nor a span log open it is one shared null
    context. It never waits for the card: it times what the host does."""
    if _LOG is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def span_log():
    """Record every span entered inside the block, on any thread, as
    ``(name, parent name, start_ns, end_ns)`` on ``time.perf_counter_ns``
    (the parent: the span open around it on its thread, or None), into the
    list this yields."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer
