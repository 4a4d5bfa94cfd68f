"""Run one cell of the benchmark with the program's spans and work counters
read, and print what they read beside the benchmark's own result.

    python3 tools/torch_span_probe.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with a card. It is a traced run
of ``perfbench/run.py`` (the same set-up, window and check), with three
readings added from outside the harness: a span log around
``PhotoEditor.open`` (the ``open.*`` spans), the work counters
(``core/params.COUNTS``: curve fits and reuses of a kept fit;
``engine/editor.COUNTS``, the geometry kernel's ``KERNEL_LAUNCHES``, the
develop kernel's ``LAUNCHES``) read
when the window's profiler starts and stops, and the program's
``editor.*`` / ``develop.*`` spans taken from that profiler's trace, whose
device idle gaps it names again by the innermost span at their middle, the
program's included. It also times a span with nothing listening and under
the profiler on this host. Prints one JSON line: ``result`` (the
benchmark's line) and ``probe``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PERFBENCH = REPO / "perfbench"
# The spans the window's ticks open, outermost first.
TICK_SPANS = ("editor.render", "editor.pack_params", "editor.geometry",
              "develop.launch", "develop.table")


def _paths():
    for p in (str(REPO), str(PERFBENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _load_run():
    spec = importlib.util.spec_from_file_location("perfbench_run", PERFBENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts():
    from rawphotoforge_tpu_torch.core import params
    from rawphotoforge_tpu_torch.engine import editor
    from rawphotoforge_tpu_torch.kernels import fused

    counts = {**params.COUNTS, **editor.COUNTS, "develop_launches": fused.LAUNCHES}
    try:  # the geometry kernel's launches, where the tree has the kernel
        from rawphotoforge_tpu_torch.kernels import geometry
    except ImportError:
        return counts
    return {**counts, **geometry.KERNEL_LAUNCHES}


def span_cost_us(n: int = 200_000) -> dict:
    """Host microseconds of one empty span: with nothing listening, and
    under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    _paths()
    from rawphotoforge_tpu_torch.utils.profiling import span

    def per_span():
        t = time.perf_counter()
        for _ in range(n):
            with span("editor.render"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_span()
    return {"off": off, "profiler": on}


def probe(workload: str, seed: int, seconds: float, device, **run_kwargs) -> dict:
    """One traced run of ``workload`` with the program's spans and counters
    read; ``run_kwargs`` go to ``perfbench/run.run``."""
    import torch.profiler

    _paths()
    from benchlib.trace import DeviceTrace
    from rawphotoforge_tpu_torch.engine.editor import PhotoEditor
    from rawphotoforge_tpu_torch.utils import profiling

    runmod = _load_run()
    seen: dict = {"open": [], "counts": []}
    open_, start, stop = PhotoEditor.open.__func__, torch.profiler.profile.start, \
        torch.profiler.profile.stop

    def logged_open(cls, *a, **k):
        with profiling.span_log() as log:
            ed = open_(cls, *a, **k)
        seen["open"] = log
        return ed

    def counted_start(self):
        seen["counts"].append(_counts())
        start(self)

    def counted_stop(self):
        stop(self)
        seen["counts"].append(_counts())
        seen["prof"] = self

    PhotoEditor.open = classmethod(logged_open)
    torch.profiler.profile.start, torch.profiler.profile.stop = counted_start, counted_stop
    try:
        out = runmod.run(workload, seed, seconds, True, device, **run_kwargs)
    finally:
        PhotoEditor.open = classmethod(open_)
        torch.profiler.profile.start, torch.profiler.profile.stop = start, stop

    tr = DeviceTrace.from_profiler(seen["prof"])
    w0, w1 = tr.window
    spans = []
    for e in seen["prof"].profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.name() in TICK_SPANS and "CUDA" not in str(e.device_type()) \
                and a >= w0 and b <= w1:
            spans.append((e.name(), a, b))
    ticks = out["attempted"]
    per_tick_ms = {n: sum(b - a for m, a, b in spans if m == n) * 1e-6 / ticks
                   for n in TICK_SPANS}
    c0, c1 = seen["counts"]
    done = {k: c1[k] - c0[k] for k in c0}
    hits = done.get("curve_fit_hits")  # None where no curve keeps its fit
    open_ms = {}
    for n, _parent, a, b in seen["open"]:
        open_ms[n] = open_ms.get(n, 0.0) + (b - a) * 1e-6
    named = DeviceTrace(tr.ops, tr.host_spans + spans, tr.window)
    return {"result": out, "probe": {
        "ticks": ticks,
        "span_ms_per_tick": per_tick_ms,
        "spans_per_tick": {n: sum(m == n for m, _, _ in spans) / ticks
                           for n in TICK_SPANS},
        "curve_fits_per_tick": done["curve_fits"] / ticks,
        "curve_fit_hits_per_tick": None if hits is None else hits / ticks,
        "curve_fit_hit_share": (hits / (hits + done["curve_fits"])
                                if hits is not None and hits + done["curve_fits"]
                                else None),
        "geometry_passes_per_tick": (done["warps"] + done["unsharps"]) / ticks,
        "develop_launches_per_tick": done["develop_launches"] / ticks,
        "geometry_launches_per_tick": (done["geometry_sharpen_kernel"] / ticks
                                       if "geometry_sharpen_kernel" in done else None),
        "counts_in_window": done,
        "open_span_ms": open_ms,
        "open_spans": [[n, p, (b - a) * 1e-6] for n, p, a, b in seen["open"]],
        "idle_gaps_named": named.idle_gaps(),
        "program_spans_among_device_ops": sorted(
            {n for n, _, _, _ in tr.ops if n in TICK_SPANS or n.startswith("open.")}),
    }}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # The settings perfbench/run.py's main makes before its run.
    work = PERFBENCH / "_work"
    os.environ["TRITON_CACHE_DIR"] = str(work / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(work / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    cost = span_cost_us()
    out = probe(args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    out["probe"]["span_cost_us"] = cost
    out["probe"]["torch"] = torch.__version__
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
