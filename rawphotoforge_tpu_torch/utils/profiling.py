"""Profiling and tracing helpers (the JAX package's ``utils/profiling.py``).

The reference's only tracing is per-call wall-clock printouts
(gpu_image_processing.rs:396-397, web/main.ts:781, raw_photo_forge.py:1891).
Here: a barrier on the devices of a result, a device-time measurement on
CUDA events, a stage timer with a per-stage report, and a
``torch.profiler`` trace context (named ``xla_trace`` after its JAX
counterpart).
"""

from __future__ import annotations

import contextlib
import os
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


class StageTimer:
    """Accumulate named stage timings and print a report."""

    def __init__(self):
        self.stages: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a block. The context yields a holder whose ``.result`` the
        block sets to its output, so that the stage waits for that output's
        device work (without it a stage records the enqueue only):

            with timer.stage("develop") as st:
                st.result = editor.apply()
        """
        class _Holder:
            result = None

        holder = _Holder()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            # Record even when the block raises (partial stage evidence
            # beats a silently missing row).
            if holder.result is not None:
                fetch_sync(holder.result)
            self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["stage timings (median over calls):"]
        for name, ts in self.stages.items():
            lines.append(
                f"  {name:<28s} {np.median(ts) * 1e3:8.2f} ms  (n={len(ts)})")
        return "\n".join(lines)


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA when
    a card is present) and write a Chrome trace (viewable in Perfetto) to
    ``log_dir/trace_<pid>.json``. Yields the profiler, whose
    ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))
