"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import PERFBENCH
from run import FORBIDDEN, forbidden_modules


@pytest.mark.parametrize("mods, found", [
    (["rawphotoforge_tpu_torch", "rawphotoforge_tpu_torch.engine.editor"], []),
    (["rawphotoforge_tpu.core.params"], ["rawphotoforge_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "jax_free"], ["jaxlib"]),
    (["flax.linen", "numpy"], ["flax"]),
])
def test_names_compare_whole(mods, found):
    assert forbidden_modules(mods) == found


def test_a_run_loads_nothing_forbidden(tmp_path):
    from tiny import tiny_checkout

    repo = tiny_checkout(tmp_path)
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from pathlib import Path\n"
        "out = run.run('xtrans26.drag', 5, 0.2, True, torch.device('cpu'), repo=Path(%r),"
        " check_cards=False, work=Path(%r))\n"
        "print('FOUND', run.forbidden_modules())\n"
    ) % (str(PERFBENCH.parent), str(PERFBENCH), str(repo), str(tmp_path / "work"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy", "torch", "math"}, (path, tops)


def test_no_benchmark_file_reads_the_jax_benchmarks():
    for path in PERFBENCH.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "bench_all" not in text and "bench.py" not in text, path
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops)
