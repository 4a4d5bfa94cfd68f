"""The port stands alone: importing it (every module) loads neither jax nor
the JAX package nor Pillow, no port source imports them, a spawned rank of
the multi-rank tests loads neither, nor do the card fuzz
(tools/torch_card_fuzz.py) and the test helpers it shares, and
chip_smoke.py refuses to run without a card or without the repository
beside it; its A/B modes cut lines that csrc/ holds."""

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
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "rawphotoforge_tpu", "PIL", "scipy"))}))
"""

# The vendor containers, the decode gate and lens correction (slice 5), the
# JPEG device wires (slice 6): each must be among the modules the probe
# imports.
SLICE_5 = ["io.vendor_packed", "io.vendor_preview", "io.cr2", "io.vendor_raw",
           "engine.instant", "ops.lenscorr", "io.lensdb"]
SLICE_6 = ["io.jpegbits", "io.jpegenc", "kernels.jpeg_wire"]
# Masks, the segmenter adapters, the geodesic sweep kernel and the v1 tone
# LUT (slice 7); scipy and Pillow load only inside their functions.
SLICE_7 = ["ops.masking", "engine.segmenter", "kernels.geodesic", "core.tonelut"]
# The interactive server: settings, translations, the host develop, the
# warm-up analog and the server itself (slice 8).
SLICE_8 = ["engine.session", "app.translations", "engine.hostdev",
           "engine.prewarm", "app.server"]
# Multi-device and transfers (slice 9): the torch.distributed layer and the
# rest of the transfer and profiling helpers.
SLICE_9 = ["parallel.mesh", "parallel.spatial", "utils.profiling",
           "utils.transfer"]


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_every_port_module_loads_no_jax_and_no_pillow():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe["loaded"] == []
    assert {f"rawphotoforge_tpu_torch.{m}"
            for m in SLICE_5 + SLICE_6 + SLICE_7 + SLICE_8 + SLICE_9
            } <= set(probe["imported"])


# The card fuzz and the jax-free test helpers it shares with chip_smoke.py:
# loading the tool, running each of its parts (at 0 seeds: the parts'
# imports) and calling the helpers must load neither jax nor the JAX package.
_FUZZ_PROBE = r"""
import importlib.util, json, sys
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("torch_card_fuzz", "tools/torch_card_fuzz.py")
fuzz = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fuzz)
assert fuzz.run(torch.device("cpu"), {k: 0 for k in fuzz.DEFAULT_COUNTS},
                log=lambda _m: None)["ok"]
import torch_fixtures as fx
from rawphotoforge_tpu_torch.core.params import pack_params
from rawphotoforge_tpu_torch.kernels import fused
r = np.random.default_rng(0)
params = pack_params([fx.random_params(r, allow_geometry=False)], device="cpu")
planes = torch.from_numpy(r.random((3, 8, 16)).astype(np.float32))
out = fused.develop_post_geo_fused(planes, params, None)
fx.assert_staircase_explained(out, planes, params, None)
fx.assert_fuzz_close(out, out)
fx.png48_bytes(r.integers(0, 65536, (4, 5, 3)).astype(np.uint16),
               lambda n: np.arange(n) % 5, interlace=True)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "rawphotoforge_tpu"))))
"""


def test_card_fuzz_and_its_helpers_load_no_jax():
    env = _clean_env()
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    out = subprocess.run([sys.executable, "-c", _FUZZ_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_card_fuzz_sources_digest_follows_the_sources(tmp_path):
    """The card-fuzz artifact's ``sources`` label: the same files give the
    same digest in another directory (build caches left out), and a byte
    changed in a kernel source changes it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_card_fuzz", ROOT / "tools" / "torch_card_fuzz.py")
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for rel in ("tools/torch_card_fuzz.py", "tests/torch_fixtures.py", "chip_smoke.py"):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        shutil.copy(ROOT / rel, tmp_path / rel)
    (tmp_path / PORT.name / "build").mkdir(exist_ok=True)
    (tmp_path / PORT.name / "build" / "stale.cu").write_text("// a cache")
    here = fuzz.sources_digest(str(ROOT))
    assert fuzz.sources_digest(str(tmp_path)) == here
    assert here["files"] > len(list((PORT / "csrc").glob("*.cu")))
    with open(tmp_path / PORT.name / "csrc" / "develop.cu", "a") as f:
        f.write("\n")
    assert fuzz.sources_digest(str(tmp_path))["sha256"] != here["sha256"]


def test_a_spawned_rank_loads_no_jax(tmp_path):
    """The multi-rank tests' ranks (tests/torch_dist.py, spawned) import
    the port and torch.distributed, never jax or the JAX package."""
    from torch_dist import loaded_modules, run_world

    assert run_world(loaded_modules, 2, tmp_path) == [[], []]


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py",
                                       ROOT / "tools" / "torch_card_fuzz.py",
                                       ROOT / "tests" / "torch_fixtures.py"]),
    ids=lambda p: p.name)
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


@pytest.mark.parametrize("variants", ["AB_VARIANTS", "BAYER_AB_VARIANTS",
                                      "JPEG_HUFFMAN_AB_VARIANTS", "GEOMETRY_AB_VARIANTS"])
def test_chip_smoke_ab_cuts_are_in_csrc(variants):
    """chip_smoke.py's --develop-ab, --bayer-ab, --jpeg-ab and --geometry-ab build csrc/
    with exact lines replaced (on the card a mode fails when a line is
    gone): every cut's text is in csrc/."""
    import chip_smoke

    texts = [p.read_text() for p in (PORT / "csrc").iterdir()]
    for name, subs in getattr(chip_smoke, variants).items():
        for text, _ in subs:
            assert any(text in t for t in texts), (variants, name, text)
