"""A configuration, a traffic mix or a metric added as files alone is
found by name; nothing in the harness names them."""

import json
import shutil

from benchlib import spec
from conftest import PERFBENCH
from tiny import REPO


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "perfbench"
    for d in ("configs", "drivers", "metrics", "reference", "traffic", "limits"):
        shutil.copytree(PERFBENCH / d, root / d)
    cfg = json.loads((PERFBENCH / "configs" / "dng-bayer-45mp.json").read_text())
    cfg["width"] = 4096
    (root / "configs" / "new-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((PERFBENCH / "traffic" / "drag.json").read_text())
    traffic["mix"] = [["tone", 1]]
    (root / "traffic" / "newmix.json").write_text(json.dumps(traffic))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 2 * ctx['x']\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "s",
                             "file": "perfbench/configs/new-config.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config",
                               "traffic": "newmix", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "l", "moves": "setup_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("new.cell", repo=tmp_path, root=root)
    assert cell.config["width"] == 4096
    assert cell.traffic["mix"] == [["tone", 1]]
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert cell.reader("new_metric")({"x": 3}) == 6
    assert cell.limits is None  # no limits file: no run of it can be correct
    assert hasattr(cell.driver(), "run") and hasattr(cell.reference(), "render")
    # The real cells keep their own per-layer metrics.
    assert "geometry_ms" not in [m["name"] for m in
                                 spec.load_cell("xtrans26.drag", repo=tmp_path, root=root).per_layer]


def test_every_metric_and_cell_has_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits, w["name"]
        assert (PERFBENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()


def test_a_traffic_mix_reuses_the_session_it_names():
    maskdrag, geodrag = (spec.load_traffic(n) for n in ("maskdrag", "geodrag"))
    assert "session" not in geodrag
    assert geodrag["masks"] == maskdrag["masks"] and geodrag["sliders"] == maskdrag["sliders"]
    assert geodrag["mix"] == [["lens_distortion", 1], ["sharpness", 1]]
    assert geodrag["alternate"] and not maskdrag.get("alternate")
