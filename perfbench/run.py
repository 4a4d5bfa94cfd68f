"""Run one cell of the benchmark of rawphotoforge_tpu_torch once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's inputs from the seed, sets the program up, runs
the traffic for ``--seconds``, checks what the program produced against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number beside its limit, which the last lines of standard error repeat.

It exits non-zero, printing no result, without enough CUDA cards, when the
program cannot be imported, and when JAX or the JAX package is loaded in
this process once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent
REPO = PERFBENCH.parent
WORK = PERFBENCH / "_work"

# Top-level module names that must not be loaded: the JAX package shares
# its prefix with the port, so names compare whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "rawphotoforge_tpu")
PROGRAM = "rawphotoforge_tpu_torch"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def result_line(cell, ctx: dict, trace: bool, device, chips: int) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    out = {"correct": False, "attempted": len(ctx["total_ms"]),
           "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = ctx["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        repo: Path = REPO, check_cards: bool = True, work: Path = WORK) -> dict:
    """One run; returns the result dict (``checks`` last). ``repo``: the
    checkout whose BENCHMARK.json names the cell; ``check_cards=False``
    skips the look for cards (the tests drive a run on the CPU); ``work``:
    where the run keeps its inputs."""
    for p in (str(REPO), str(PERFBENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from benchlib import check, spec

    cell = spec.load_cell(workload, repo=repo)
    if check_cards:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(
                f"{workload} needs {cell.chips} CUDA card(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if importlib.util.find_spec(PROGRAM) is None:
        raise SystemExit(f"the program {PROGRAM} is not in this checkout")
    work.mkdir(parents=True, exist_ok=True)
    log(f"cell {workload}, seed {seed}, {seconds} s, trace {int(trace)}; card: {card_line()}")
    ctx = cell.driver().run(cell, seed, seconds, trace, device, work, log)
    out = result_line(cell, ctx, trace, device, cell.chips)
    correct, held = check.judge(ctx["compared"], cell.limits)
    out["correct"] = bool(correct and ctx["failed"] == 0 and ctx["n_compared"] > 0)
    out["checks"] = held
    log(f"ticks: {len(ctx['total_ms'])}, develop launches per tick "
        f"{ctx['launches'] / max(1, len(ctx['total_ms'])):.4f}")
    return out


def log_checks(out: dict) -> None:
    for name, v in out["checks"].items():
        log(f"check {name}: {v['value']!r} limit {v['limit']!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every cache of the program stays inside this checkout, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = str(WORK / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(WORK / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # One process with few threads: no library's pool of its own beside the
    # program's (the open's tile decode keeps its threads).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    t0 = time.perf_counter()
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"refused: the process has loaded {', '.join(found)}")
        return 3
    log(f"run: {time.perf_counter() - t0:.1f} s")
    log_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
