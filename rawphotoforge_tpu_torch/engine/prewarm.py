"""Warm-up before the user's first slider: the CUDA analog of the JAX
package's ``engine/prewarm.py``.

CUDA has no per-shape compile, so what the JAX module spends its time on
(compiling the develop, resize, quantize, sparse-export and RAW programs
per bucket shape) has no counterpart here. What a first request does pay
on the card is building the libraries (``nvcc`` for the kernels of
``csrc/``, ``g++`` for the native host library) and a shape's first
render, which reads high on the host clock (the first launches at a new
shape allocate and load). ``warm_async`` does both on a daemon thread:
it builds the libraries the server's path launches and renders the given
editor's MID and LOW once.

A failure here is reported on stderr and surfaces again on the next
request that needs the library (its ``library()`` builds anew and raises):
warming never turns a failure into a silent CPU path.

The shape tables (``STANDARD_ASPECTS``, ``CANONICAL_SENSOR_SHAPES``,
``XTRANS_SENSOR_SHAPES``) and ``preview_shapes`` keep the JAX package's
values; the per-shape warmers (``warm_shape``, ``warm_curve_programs``,
``warm_full_shape``, ``warm_sparse_export``, ``warm_raw_exact``) have no
CUDA meaning and are not ported (ROADMAP.md).
"""

from __future__ import annotations

import sys
import threading

# (aspect_w, aspect_h) of the sensor formats that cover essentially all
# cameras: 3:2 (full-frame/APS-C), 4:3 (MFT/phones), 16:9 (video crops),
# 1:1, plus portrait orientations.
STANDARD_ASPECTS = (
    (3, 2), (2, 3), (4, 3), (3, 4), (16, 9), (9, 16), (1, 1),
)

# Canonical sensor dimensions (h, w) + portrait twins.
CANONICAL_SENSOR_SHAPES = (
    (4000, 6000), (6000, 4000),   # 24MP 3:2 (most FF/APS-C)
    (3000, 4000), (4000, 3000),   # 12MP 4:3 (phones, older MFT)
    (4160, 6240), (6240, 4160),   # 26MP APS-C (Fuji X-Trans IV/V)
    (5464, 8192), (8192, 5464),   # 45MP FF (R5/Z8-class)
)

# Fuji X-Trans sensor extents (landscape storage).
XTRANS_SENSOR_SHAPES = ((4160, 6240), (5152, 7728))

# The pyramid levels a warm renders: the first preview and the first drag.
LEVELS = ("mid", "low")


def preview_shapes(
    mid_long_edge: int, low_long_edge: int,
    aspects=STANDARD_ASPECTS,
) -> list[tuple[int, int]]:
    """True (h, w) preview dimensions for the standard aspects: each level
    is the original resized so its long edge equals the configured preview
    size, so for any photo bigger than the preview the true preview shape
    depends only on the aspect ratio (engine.editor.PhotoEditor)."""
    from ..ops.geometry import resize_long_edge_shape

    out = []
    for edge in (mid_long_edge, low_long_edge):
        for aw, ah in aspects:
            # A representative source comfortably larger than the edge;
            # resize_long_edge_shape only uses the h:w ratio.
            h, w = ah * 1000, aw * 1000
            out.append(resize_long_edge_shape(h, w, edge))
    # Dedup, stable order.
    seen: set[tuple[int, int]] = set()
    uniq = []
    for s in out:
        if s not in seen:
            seen.add(s)
            uniq.append(s)
    return uniq


def server_libraries(device) -> tuple:
    """The library modules the server's path loads on ``device``: the
    develop, geometry-and-sharpen, geodesic sweep and JPEG kernels on a
    card, and the native host library (the host drag and the era renders)
    everywhere."""
    from .. import native
    from ..kernels import fused, geodesic, geometry, jpeg_wire

    if device is not None and device.type == "cuda":
        return (fused, geometry, geodesic, jpeg_wire, native)
    return (native,)


def session_libraries(device) -> tuple:
    """The kernel libraries an editing session on ``device`` launches: the
    develop and geometry-and-sharpen kernels on a card, none elsewhere."""
    from ..kernels import fused, geometry

    if device is not None and device.type == "cuda":
        return (fused, geometry)
    return ()


def build_libraries(device, mods=None) -> None:
    """Build (or load) every library of ``mods`` (by default
    ``server_libraries(device)``), one thread each; the first failure
    raises."""
    from concurrent.futures import ThreadPoolExecutor

    mods = server_libraries(device) if mods is None else mods
    with ThreadPoolExecutor(max(len(mods), 1)) as pool:
        for fut in [pool.submit(m.library) for m in mods]:
            fut.result()


def build_async(device):
    """Start building ``session_libraries(device)`` on a daemon thread, so
    that a checkout's first ``nvcc`` runs overlap the caller's host decode
    instead of following it at the first render and the first geometry
    pass. Returns the thread, or None off a card. A failure is reported on
    stderr; the launch that needs the library builds anew and raises."""
    mods = session_libraries(device)
    if not mods:
        return None

    def run():
        try:
            build_libraries(device, mods)
        except Exception as e:  # noqa: BLE001 — met again by the launch
            print(f"kernel build failed ({type(e).__name__}: {e})", file=sys.stderr)

    t = threading.Thread(target=run, name="rpf-build", daemon=True)
    t.start()
    return t


def warm_editor_levels(editor, lock) -> None:
    """Render an open editor's ``LEVELS`` once (the lazy FULL->level resize
    and the level's first develop launch), holding ``lock`` (the server's
    session lock) around each render so a concurrent edit never sees a
    half-updated cache."""
    for level in LEVELS:
        with lock:
            editor.apply(level, cropped=False)


def warm_async(lock, editor=None, device=None) -> threading.Thread:
    """Spawn a daemon thread that builds the server's libraries for
    ``device`` (the editor's when an editor is given) and then renders the
    editor's levels once (``warm_editor_levels``). The thread never raises:
    a failure is reported on stderr, and the next request that needs the
    library meets it again."""
    dev = editor.device if editor is not None else device

    def run():
        try:
            build_libraries(dev)
            if editor is not None:
                warm_editor_levels(editor, lock)
        except Exception as e:  # noqa: BLE001 — met again by the next request
            print(f"prewarm failed ({type(e).__name__}: {e})", file=sys.stderr)

    t = threading.Thread(target=run, name="rpf-prewarm", daemon=True)
    t.start()
    return t
