"""What the profiler saw on the device during the window.

The window is the benchmark's own ``bench.window`` range; the host spans
``tick.edit``, ``tick.render`` and ``tick.wait`` name what the host was
doing, and label the device's idle gaps. Device activity is every kernel,
copy and fill the profiler recorded on the card.
"""

from __future__ import annotations

import re

WINDOW = "bench.window"
HOST_SPANS = ("tick.edit", "tick.render", "tick.wait", "bench.capture")


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", s)[:64]


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class DeviceTrace:
    """Device intervals and host spans of one traced window, in ns."""

    def __init__(self, device_ops, host_spans, window):
        self.window = window                      # (start, end)
        w0, w1 = window
        self.ops = [(n, max(a, w0), min(b, w1), kind)
                    for n, a, b, kind in device_ops if b > w0 and a < w1]
        self.host_spans = host_spans              # [(name, start, end)]

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        dev, host, window = [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if "CUDA" in str(e.device_type()):
                # The profiler also projects the host's ranges onto the
                # device's timeline; those are not device work.
                if name != WINDOW and name not in HOST_SPANS:
                    dev.append((name, start, end, _kind(name)))
            elif name == WINDOW:
                window = (start, end)
            elif name in HOST_SPANS:
                host.append((name, start, end))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        return cls(dev, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of the device's intervals, sorted."""
        out = []
        for _, a, b, _ in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def seconds(self, match) -> tuple[float, int]:
        """Total device seconds and count of the ops for which
        ``match(name, kind)`` holds (``kind``: ``kernel``, ``memcpy`` or
        ``memset``)."""
        hits = [b - a for n, a, b, kind in self.ops if match(n, kind)]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, k: int = 10):
        by = {}
        for n, a, b, _ in self.ops:
            key = _name(n)
            by[key] = by.get(key, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t * 1e-9] for n, t in top]

    def idle_gaps(self, k: int = 10):
        """The longest gaps with no device op, each named by the innermost
        host span running at its middle."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            around = [(e - s, n) for n, s, e in self.host_spans if s <= mid < e]
            label = "host:" + (min(around)[1] if around else "other")
            out.append([label, (b - a) * 1e-9])
        return out
