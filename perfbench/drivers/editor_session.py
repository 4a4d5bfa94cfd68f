"""One photographer's editing session, a closed loop with one client.

The benchmark's DNG of the seed is written once, by a process of its own
(``perfbench/write_input.py``), into the work directory, and read by every
later run of the same configuration and seed (the file's name holds the
seed and a digest of the configuration): the timed process never encodes,
so each of its runs starts alike. Set-up opens it
with ``PhotoEditor.open``, adds the traffic's regional masks through
``add_mask``, sets the script's initial edit and renders one tick of each
kind the traffic moves, so that every shape the window uses is built and
warm. The window then runs the script's ticks one after another: each
moves one slider (``PhotoEditor``'s setters) and re-renders at full
resolution, ``apply(FULL)``, and waits for the card; the next tick starts
when it returns. A tick is timed on the host clock from the slider call
to the return of the synchronize.

Two ticks drawn from the seed and the window's last tick keep their
renders. Once the window has closed and the session is freed, the plain
reference renders the same edit states from the benchmark's own mosaic and
mask logits, and ``check.gaps`` compares them.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from benchlib import check, dngwrite, host, scene
from benchlib.script import TONE, WB, Script
from benchlib.stats import percentile
from benchlib.trace import WINDOW, DeviceTrace

FULL = "full"
BUCKET = 128  # the editor pads every level to multiples of this


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _set_state(ed, names, state):
    for name, p in zip(names, state["masks"]):
        ed.set_tone(*(p[k] for k in TONE), mask_name=name)
        ed.set_whitebalance(*(p[k] for k in WB), mask_name=name)
        for slot, curve in enumerate(p["curves"]):
            if curve is not None:
                ed.set_curve(slot, curve[0], curve[1], mask_name=name)
    main = state["main"]
    ed.set_vignette(main["vignette"])
    ed.set_lens_distortion(main["lens_distortion"])
    ed.set_sharpness(main["sharpness"])


def _apply_tick(ed, names, tick):
    k, kind, payload = tick
    if kind == "tone":
        ed.set_tone(*payload, mask_name=names[k])
    elif kind == "wb":
        ed.set_whitebalance(*payload, mask_name=names[k])
    elif kind == "curve":
        ed.set_curve(payload[0], payload[1], payload[2], mask_name=names[k])
    elif kind == "vignette":
        ed.set_vignette(payload)
    elif kind == "lens_distortion":
        ed.set_lens_distortion(payload)
    elif kind == "sharpness":
        ed.set_sharpness(payload)
    else:
        raise ValueError(f"unknown tick kind {kind!r}")


def develop_work(state: dict, logits, true_hw) -> dict:
    """What one develop launch of this edit must do, for the frozen op and
    byte counts: masks, curve segments (control points padded to a power of
    two), default curves, each mask's share of the bucket grid, the
    vignette."""
    hb, wb = (n + (-n) % BUCKET for n in true_hw)
    points = [2 if c is None else len(c[0]) for p in state["masks"] for c in p["curves"]]
    s = min(1 << (max(points) - 1).bit_length(), 32)
    slots = [tuple(c is None for c in p["curves"]) for p in state["masks"]]
    identity = all(all(sl[1:]) for sl in slots)
    coverage = [1.0] + [float((lg >= 0.0).sum()) / (hb * wb) for lg in logits]
    return {"m": len(state["masks"]), "s": s, "slots": slots, "identity": identity,
            "coverage": coverage, "vignette_on": int(state["main"]["vignette"] != 0),
            "hw": hb * wb}


def make_inputs(cell, seed: int, device):
    """The seeded mosaic (host int32) and the regional masks' logits (host
    f32)."""
    cfg, meta = cell.config, cell.meta
    h, w = int(cfg["height"]), int(cfg["width"])
    mos = scene.mosaic(scene.scene(seed, h, w, device), meta)
    logits = [scene.mask_logits(m["kind"], m["coverage"], seed, i, h, w, device).cpu().numpy()
              for i, m in enumerate(cell.traffic.get("masks", []))]
    return mos.cpu().numpy(), logits


def write_dng(cell, seed: int, device, path) -> None:
    """Write the seed's DNG to ``path`` (through a ``.part`` file, so a
    reader sees all of it or nothing)."""
    cfg, meta = cell.config, cell.meta
    mos = scene.mosaic(scene.scene(seed, int(cfg["height"]), int(cfg["width"]), device), meta)
    dng = dngwrite.dng_bytes(mos, meta)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    with open(part, "wb") as f:
        f.write(dng)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, path)


def reference_renders(cell, mosaic, logits, states, device, dtype=torch.float32):
    """The plain reference's render of each edit state, one at a time."""
    ref = cell.reference()
    linear = ref.develop_mosaic(mosaic, cell.meta, device, dtype=dtype)
    for state in states:
        yield ref.render(linear, state, logits, device)


def run(cell, seed: int, seconds: float, trace: bool, device, workdir, log) -> dict:
    """One run of the cell; returns the context the metric readers read."""
    ctx: dict = {"cell": cell.name, "failed": 0}
    t = time.perf_counter()
    digest = hashlib.sha256(json.dumps(cell.config, sort_keys=True).encode()).hexdigest()
    path = workdir / "dng" / f"{cell.config_name}.{int(seed)}.{digest[:12]}.dng"
    cached = path.is_file()
    if not cached:
        subprocess.run([sys.executable, str(cell.root / "write_input.py"),
                        "--repo", str(cell.repo), "--workload", cell.name, "--seed",
                        str(int(seed)), "--device", str(device), "--out", str(path)],
                       check=True)
    mosaic, logits = make_inputs(cell, seed, device)
    _sync(device)
    gc.collect()
    log(f"inputs: {path.stat().st_size} B DNG ({'kept' if cached else 'written'}), "
        f"{len(logits)} masks, {time.perf_counter() - t:.3f} s (not set-up)")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # -- set-up ---------------------------------------------------------------
    t_setup = time.perf_counter()
    from rawphotoforge_tpu_torch.engine.editor import PhotoEditor
    from rawphotoforge_tpu_torch.kernels import fused

    t = time.perf_counter()
    ed = PhotoEditor.open(str(path), device=device)
    _sync(device)
    ctx["open_ms"] = (time.perf_counter() - t) * 1e3
    cfg = cell.config
    true_hw = (int(cfg["height"]), int(cfg["width"]))
    if tuple(ed.shape) != true_hw:
        raise RuntimeError(f"the session opened at {ed.shape}, not {true_hw}")
    names = ["main"]
    for m, lg in zip(cell.traffic.get("masks", []), logits):
        ed.add_mask(m["name"], lg)
        names.append(m["name"])
    script = Script(cell.traffic, seed, true_hw)
    _set_state(ed, names, script.state)
    ed.apply(FULL)
    _sync(device)
    for kind in script.kinds:
        _apply_tick(ed, names, script.next(kind))
        ed.apply(FULL)
        _sync(device)
    n_warm = len(script.ticks)
    ctx["setup_s"] = time.perf_counter() - t_setup
    log(f"set-up: open {ctx['open_ms']:.1f} ms, {len(names)} masks, "
        f"{n_warm} warm-up ticks, {ctx['setup_s']:.3f} s")

    # -- the window -----------------------------------------------------------
    capture_at = set(script.capture_ticks(seed))
    captured = {}
    host_ms, total_ms = [], []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        span = record_function
    else:
        prof = contextlib.nullcontext()

        def span(_name):
            return contextlib.nullcontext()

    launches0 = fused.LAUNCHES
    out = None
    kinds = []
    log(f"before the window: host probe {host.probe_ms():.4f} ms, card {host.card_clocks()}")
    with prof:
        with span(WINDOW):
            t_start = time.perf_counter()
            t_end = t_start + seconds
            i = 0
            while True:
                tick = script.next()
                kinds.append(tick[1])
                t0 = time.perf_counter()
                try:
                    with span("tick.edit"):
                        _apply_tick(ed, names, tick)
                    with span("tick.render"):
                        out = ed.apply(FULL)
                    t1 = time.perf_counter()
                    with span("tick.wait"):
                        _sync(device)
                except Exception as e:  # noqa: BLE001 — a failed tick is counted
                    ctx["failed"] += 1
                    log(f"tick {i} failed: {type(e).__name__}: {e}")
                    t1 = time.perf_counter()
                    out = None
                t2 = time.perf_counter()
                host_ms.append((t1 - t0) * 1e3)
                total_ms.append((t2 - t0) * 1e3)
                if i in capture_at and out is not None:
                    with span("bench.capture"):
                        captured[i] = out.clone()
                i += 1
                if t2 >= t_end:
                    break
            window_s = time.perf_counter() - t_start
            if out is not None and (i - 1) not in captured:
                captured[i - 1] = out.clone()
            _sync(device)
    ctx.update(window_s=window_s, host_ms=host_ms,
               total_ms=total_ms, launches=fused.LAUNCHES - launches0)
    ctx["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    if trace:
        ctx["trace"] = DeviceTrace.from_profiler(prof)
    ctx["develop_work"] = develop_work(script.state_after(n_warm), logits, true_hw)
    log(f"window: {len(total_ms)} ticks in {ctx['window_s']:.3f} s, "
        f"{ctx['launches']} develop launches, {ctx['failed']} failed")
    log(f"after the window: host probe {host.probe_ms():.4f} ms, card {host.card_clocks()}")
    if total_ms:
        log("tick ms p1/p10/p25/p50/p75/p90/p99/max: " + " ".join(
            f"{percentile(total_ms, q):.4f}" for q in (1, 10, 25, 50, 75, 90, 99, 100))
            + f"; host mean {sum(host_ms) / len(host_ms):.4f}, rest mean "
            f"{(sum(total_ms) - sum(host_ms)) / len(host_ms):.4f}")
        for kind in sorted(set(kinds)):
            tot = [t for t, k in zip(total_ms, kinds) if k == kind]
            hst = [t for t, k in zip(host_ms, kinds) if k == kind]
            log(f"  {kind}: {len(tot)} ticks, p50 {percentile(tot, 50):.4f}, "
                f"host mean {sum(hst) / len(hst):.4f}, rest mean "
                f"{(sum(tot) - sum(hst)) / len(hst):.4f}")

    # -- correctness, once the session is freed ---------------------------------
    del ed, out, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ticks = sorted(captured)
    states = [script.state_after(n_warm + i + 1) for i in ticks]
    readings = []
    for i, ref_img in zip(ticks, reference_renders(cell, mosaic, logits, states, device)):
        g = check.gaps(captured.pop(i), ref_img)
        readings.append(g)
        log(f"tick {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in g.items()))
    ctx["compared"] = check.worst(readings)
    ctx["n_compared"] = len(readings)
    log(f"reference: {len(readings)} renders in {time.perf_counter() - t:.3f} s")
    return ctx
