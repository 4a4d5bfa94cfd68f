"""A checkout-shaped directory whose BENCHMARK.json names the real cells
at a size a CPU test run holds."""

import json
from pathlib import Path

from conftest import PERFBENCH

REPO = PERFBENCH.parent
TINY_HW = (70, 102)  # not bucket-aligned: the pad and its edges are exercised


def tiny_checkout(tmp: Path, hw=TINY_HW, tile=(32, 32)) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["height"], cfg["width"], cfg["tile"] = hw[0], hw[1], list(tile)
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cells():
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
