"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds. The build
runs at first use (never at import) into ``<package>/build/`` (listed in
.gitignore), keyed by a hash of the sources and flags, and an existing
library of the same key is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from .._errbase import PhotoEditorError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# Exact IEEE division and square root (the slot shortcuts' bit-identity
# rests on 32767/32767.5 and floor(v*65535) being computed exactly as the
# general path computes them), and no multiply-add contraction, so the
# kernel rounds each operation as its plain torch twin does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-prec-div=true", "-prec-sqrt=true",
    "-fmad=false", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise PhotoEditorError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")


# One build at a time per library: a server's warm-up thread and its first
# request may both ask for the same library.
_BUILD_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}


def build(name: str, main_source: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``csrc/<main_source>`` (with every header in ``csrc/``) and
    load it. Returns the library and a build record: ``seconds`` (0.0 when
    an existing build was reused), ``log`` (nvcc's output, including the
    ``-Xptxas -v`` register and spill report) and ``path``."""
    with _BUILD_LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build(name, main_source)


def _build(name: str, main_source: str) -> tuple[ctypes.CDLL, dict]:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    record = {"seconds": 0.0, "log": "", "path": str(out)}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / main_source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise PhotoEditorError(
                f"nvcc failed for {main_source}:\n{record['log']}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(out)), record
