"""The benchmark's description, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. Everything that belongs to one of them is a
file of its own under ``perfbench/``:

- a configuration: the JSON file ``BENCHMARK.json`` gives as its ``file``,
  which names its plain reference, ``reference/<reference>.py``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
  code that runs it, ``drivers/<driver>.py``; a mix that reuses another's
  session names it as ``"session": "<traffic>"`` and holds only what it
  changes;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
  ``read(ctx)`` returns the number or None;
- a cell's limits for the comparison that decides ``correct``:
  ``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
REPO = PERFBENCH.parent


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{path.parent.name}_{path.stem}".replace("-", "_").replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict | None
    root: Path = field(default=PERFBENCH)
    repo: Path = field(default=REPO)

    @property
    def meta(self) -> dict:
        """The configuration with its levels and colour as numbers: the
        DNG's rationals divided out as a reader divides them."""
        meta = dict(self.config)
        meta["color_matrix"] = [v / 10000 for v in self.config["color_matrix_1e4"]]
        meta["as_shot_neutral"] = [v / 1000000 for v in self.config["as_shot_neutral_1e6"]]
        return meta

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['driver']}.py")

    def reference(self):
        return load_module(self.root / "reference" / f"{self.config['reference']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py").read


def load_traffic(name: str, root: Path = PERFBENCH) -> dict:
    """``traffic/<name>.json``, over the mix it names as its session."""
    traffic = json.loads((root / "traffic" / f"{name}.json").read_text())
    base = traffic.pop("session", None)
    return {**load_traffic(base, root), **traffic} if base else traffic


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, repo: Path = REPO, root: Path = PERFBENCH) -> Cell:
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((repo / cfg["file"]).read_text())
    traffic = load_traffic(w["traffic"], root)
    limits_path = root / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None
    return Cell(
        name=name, config_name=w["config"], chips=int(w["chips"]), config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=limits, root=root, repo=repo)
