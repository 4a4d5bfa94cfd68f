"""The port stands alone: importing it (every module) loads neither jax nor
the JAX package nor Pillow, no port source imports them, and chip_smoke.py
refuses to run without a card or without the repository beside it."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "rawphotoforge_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import rawphotoforge_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "rawphotoforge_tpu", "PIL"))))
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_every_port_module_loads_no_jax_and_no_pillow():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]), ids=lambda p: p.name)
def test_no_port_source_imports_jax(path):
    src = path.read_text()
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rawphotoforge_tpu)(\s|\.|$)", re.M)
    assert not bad.search(src), f"{path} imports jax or the JAX package"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, str(Path(cwd) / "chip_smoke.py")], cwd=cwd,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_a_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr
