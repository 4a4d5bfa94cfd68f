"""``correct`` comes out false for the control and for each fault a cell
can have, driving a whole run on the CPU at a tiny size with the timed
path broken underneath (the look for a card skipped)."""

import pytest
import torch

import run as runmod
from benchlib import check, spec
from tiny import TINY_HW, cells, tiny_checkout

CPU = torch.device("cpu")
SEED = 3 * 2**31 + 5


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


def _run(workload, repo):
    return runmod.run(workload, SEED, 0.3, False, CPU, repo=repo, check_cards=False,
                      work=repo / "work")


@pytest.mark.parametrize("workload", cells())
def test_a_sound_run_is_correct(workload, repo):
    out = _run(workload, repo)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", cells())
def test_stale_render_is_not_correct(workload, repo, monkeypatch):
    """A tick that returns the state it had: every render after the first
    is the first one."""
    from rawphotoforge_tpu_torch.kernels import fused

    real = fused.develop_post_geo_fused
    first = {}

    def stale(*a, **k):
        if "out" not in first:
            first["out"] = real(*a, **k)
        return first["out"]

    monkeypatch.setattr(fused, "develop_post_geo_fused", stale)
    assert not _run(workload, repo)["correct"]


@pytest.mark.parametrize("workload", cells())
def test_altered_answer_is_not_correct(workload, repo, monkeypatch):
    """One value of each render altered where it is produced, on the most
    colourful pixel of its true region (a near-neutral pixel's lone value
    is ``share_off``'s to catch, and one value is under its limit)."""
    from rawphotoforge_tpu_torch.kernels import fused

    real = fused.develop_post_geo_fused
    h, w = TINY_HW

    def altered(*a, **k):
        out = real(*a, **k).clone()
        y, x = divmod(int(check.chroma(out[:, :h, :w]).argmax()), w)
        v = float(out[1, y, x])
        out[1, y, x] = v + 0.05 if v < 0.9 else v - 0.05
        return out

    monkeypatch.setattr(fused, "develop_post_geo_fused", altered)
    assert not _run(workload, repo)["correct"]


@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(workload, repo):
    """The reference in bfloat16, in the program's place, against the
    float32 reference on the same edit states, fails the cell's limits."""
    from benchlib.script import Script

    cell = spec.load_cell(workload, repo=repo)
    drv = cell.driver()
    mosaic, logits = drv.make_inputs(cell, SEED, CPU)
    h, w = int(cell.config["height"]), int(cell.config["width"])
    script = Script(cell.traffic, SEED, (h, w))
    for _ in range(30):
        script.next()
    states = [script.state_after(n) for n in (10, 30)]
    exact = drv.reference_renders(cell, mosaic, logits, states, CPU)
    low = drv.reference_renders(cell, mosaic, logits, states, CPU, dtype=torch.bfloat16)
    numbers = check.worst([check.gaps(b, a) for a, b in zip(exact, low)])
    correct, held = check.judge(numbers, cell.limits)
    assert not correct, held


def test_the_input_file_is_written_once_and_kept(tmp_path):
    """The first run of a seed writes its DNG in a process of its own; the
    next run of that configuration and seed reads the same file."""
    repo = tiny_checkout(tmp_path)
    work = tmp_path / "work"
    runmod.run("xtrans26.drag", SEED + 1, 0.2, False, CPU, repo=repo, check_cards=False,
               work=work)
    (first,) = (work / "dng").glob("*.dng")
    stamp = first.stat().st_mtime_ns
    out = runmod.run("xtrans26.drag", SEED + 1, 0.2, False, CPU, repo=repo,
                     check_cards=False, work=work)
    assert out["correct"]
    assert list((work / "dng").glob("*")) == [first] and first.stat().st_mtime_ns == stamp
