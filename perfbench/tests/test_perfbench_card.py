"""On a card: each cell at a tiny size through run.py's whole path, the
develop kernel and the profiler's trace included."""

import pytest
import torch

import run as runmod
from tiny import cells, tiny_checkout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_cell_runs_on_the_card(workload, card, tmp_path):
    repo = tiny_checkout(tmp_path, hw=(300, 420), tile=(64, 64))
    out = runmod.run(workload, 2**31 + 99, 1.0, True, card, repo=repo,
                     work=repo / "work")
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert "develop_kernel_roofline" in out["metrics"]
    assert out["metrics"]["develop_kernel_roofline"]["value"] <= 105
