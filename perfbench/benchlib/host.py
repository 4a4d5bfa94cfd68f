"""Readings of the machine around a window, logged beside it and held to
no limit: how fast the host's core runs fixed Python work, and the card's
clock, temperature and power."""

from __future__ import annotations

import statistics
import subprocess
import time


def probe_ms(reps: int = 5) -> float:
    """Median milliseconds of a fixed piece of pure Python (a tick's host
    part is Python of this kind): the host core's speed at the time."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i % 7
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def card_clocks() -> str:
    """The card's SM clock, temperature and power draw as ``nvidia-smi``
    reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
