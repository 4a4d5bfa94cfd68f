"""The plain reference against the port, at a tiny size on the CPU: the
benchmark's DNG decodes to its mosaic, the opened planes equal the
reference's developed mosaic, and renders agree within the develop
kernel's twin's distance from the exact-LUT stack."""

import numpy as np
import pytest
import torch

from benchlib import check, spec
from benchlib.script import Script
from tiny import TINY_HW, cells, tiny_checkout

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", cells())
def test_reference_matches_the_port(workload, repo, tmp_path):
    from rawphotoforge_tpu_torch.engine.editor import PhotoEditor
    from rawphotoforge_tpu_torch.io.dng import read_dng

    cell = spec.load_cell(workload, repo=repo)
    drv = cell.driver()
    seed = 2**31 + 11
    mosaic, logits = drv.make_inputs(cell, seed, CPU)
    path = tmp_path / "x.dng"
    drv.write_dng(cell, seed, CPU, path)
    raw = read_dng(path.read_bytes())
    assert np.array_equal(raw.mosaic.astype(np.int32), mosaic)
    ed = PhotoEditor.open(str(path), device="cpu")
    names = ["main"]
    for m, lg in zip(cell.traffic.get("masks", []), logits):
        ed.add_mask(m["name"], lg)
        names.append(m["name"])
    ref = cell.reference()
    linear = ref.develop_mosaic(mosaic, cell.meta, CPU)
    h, w = TINY_HW
    assert torch.equal(ed._originals["full"][:, :h, :w], linear[:, :h, :w])

    script = Script(cell.traffic, seed, TINY_HW)
    for kind in script.kinds:
        script.next(kind)
    for _ in range(60):
        script.next()
    for n in (0, len(script.ticks) // 2, len(script.ticks)):
        state = script.state_after(n)
        drv._set_state(ed, names, state)
        got = check.gaps(ed.apply("full"), ref.render(linear, state, logits, CPU))
        assert got["max_gap"] < 1e-3 and got["share_off"] == 0.0, (n, got)


def test_curves_are_the_exact_tables():
    from rawphotoforge_tpu_torch.core.curve import build_lut

    from reference.raw_session import pchip_lut

    r = np.random.default_rng(3)
    for _ in range(20):
        n = int(r.integers(2, 9))
        xs = np.unique(np.concatenate([[0, 65535], r.integers(1, 65535, size=n)]))
        ys = r.integers(0, 65536, size=len(xs))
        assert np.array_equal(pchip_lut(xs, ys), build_lut(xs, ys))
