"""The readings the limits of ``correct`` are set from, on the card.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--seconds 3] [--out chiprun_out/x.jsonl]

For each ``--seeds`` seed, one run of the cell exactly as ``run.py`` makes
it (a short window at the cell's own load and size), with the numbers the
comparison read: the program's readings, the lower end of each limit. For
each ``--control-seeds`` seed, the control: the plain reference computed in
bfloat16, one precision step below the float32 that the configuration
states, put in the program's place for the same edit states that a run
compares (the two drawn ticks and a last one), against the float32
reference: the upper end. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
for p in (str(PERFBENCH.parent), str(PERFBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_reading(cell, seed: int, device) -> dict:
    """The bfloat16 reference against the float32 one, worst over the edit
    states a run compares."""
    import torch

    from benchlib import check
    from benchlib.script import Script

    drv = cell.driver()
    mosaic, logits = drv.make_inputs(cell, seed, device)
    cfg = cell.config
    script = Script(cell.traffic, seed, (int(cfg["height"]), int(cfg["width"])))
    for kind in script.kinds:
        script.next(kind)
    n_warm = len(script.ticks)
    last = int(cell.traffic["capture_within"])
    ticks = script.capture_ticks(seed) + [last]
    for _ in range(last + 1):
        script.next()
    states = [script.state_after(n_warm + i + 1) for i in ticks]
    readings = []
    exact = drv.reference_renders(cell, mosaic, logits, states, device)
    low = drv.reference_renders(cell, mosaic, logits, states, device, dtype=torch.bfloat16)
    for a, b in zip(exact, low):
        readings.append(check.gaps(b, a))
        del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return check.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    import run as runmod
    from benchlib import spec

    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    cell = spec.load_cell(args.workload)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(obj) + "\n")

    for seed in args.seeds:
        t = time.perf_counter()
        out = runmod.run(args.workload, seed, args.seconds, False, dev)
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              "numbers": {k: v["value"] for k, v in out["checks"].items()},
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        emit({"workload": args.workload, "seed": seed, "kind": "control_bf16",
              "numbers": control_reading(cell, seed, dev),
              "seconds": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
