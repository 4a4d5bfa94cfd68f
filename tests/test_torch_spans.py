"""The port's spans (``utils/profiling.span`` / ``span_log``) and its work
counters (``core/params.COUNTS``, ``engine/editor.COUNTS``) on the CPU: a
span with nothing listening is the shared null context; a span log records
nesting, closes a raising span and keeps each thread's parents apart;
under ``torch.profiler`` a span is an event of the trace that is no user
annotation (the profiler projects user annotations onto the card's
timeline as device ranges); the editor fits again only the curves an edit
moved, and counts the geometry passes it redoes; a DNG open records each
of its three stages once."""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu_torch.core import params as tparams
from rawphotoforge_tpu_torch.engine import editor as teditor
from rawphotoforge_tpu_torch.utils import profiling


def test_span_with_nothing_listening_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("editor.render") is profiling._NULL
    assert profiling.span("open.pad") is profiling._NULL
    with profiling.span("editor.render") as s:
        assert s is None
    assert profiling._STACK.names == []


def test_span_log_records_parents_and_closes_a_raising_span():
    with profiling.span_log() as log:
        with profiling.span("editor.render"):
            with profiling.span("editor.pack_params"):
                pass
            with pytest.raises(ValueError):
                with profiling.span("editor.geometry"):
                    raise ValueError("boom")
        with profiling.span("develop.launch"):
            pass
    assert [(n, p) for n, p, _, _ in log] == [
        ("editor.pack_params", "editor.render"),
        ("editor.geometry", "editor.render"),
        ("editor.render", None), ("develop.launch", None)]
    starts = {n: (a, b) for n, _, a, b in log}
    outer = starts["editor.render"]
    for name in ("editor.pack_params", "editor.geometry"):
        a, b = starts[name]
        assert outer[0] <= a <= b <= outer[1]
    # The log is closed: spans record nothing and cost nothing again.
    assert profiling.span("editor.render") is profiling._NULL
    assert profiling._STACK.names == []


def test_span_log_takes_each_threads_own_parent():
    import sys
    import threading

    def work(i):
        for _ in range(200):
            with profiling.span(f"outer.{i}"):
                with profiling.span(f"inner.{i}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.span_log() as log:
            threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(log) == 8 * 200 * 2
    for name, parent, _, _ in log:
        kind, i = name.split(".")
        assert parent == (f"outer.{i}" if kind == "inner" else None)


def test_spans_are_trace_events_that_are_no_user_annotations():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("editor.render"):
            with profiling.span("develop.table"):
                torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner = events["editor.render"], events["develop.table"]
    for e in (outer, inner):
        assert "CPU" in str(e.device_type()) and not e.is_user_annotation()
    assert outer.start_ns() <= inner.start_ns()
    assert (inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())
    parents = {e.name: e.cpu_parent for e in prof.events()}
    assert parents["develop.table"].name == "editor.render"


def _session(n_masks: int, hw=(40, 56)):
    rng = np.random.default_rng(5)
    ed = teditor.PhotoEditor.from_rgb_f32(
        rng.random((*hw, 3)).astype(np.float32), device="cpu")
    for i in range(n_masks):
        logits = np.full(hw, -1.0, np.float32)
        logits[:, i * 8:(i + 1) * 8 + 4] = 1.0
        ed.add_mask(f"m{i}", logits)
        ed.set_curve(0, [0, 30000, 65535], [0, 36000, 65535], mask_name=f"m{i}")
    # Three points on the main mask too: every session pads to 4 segments,
    # so a three-point curve edit changes no other curve's fit.
    ed.set_curve(0, [0, 34000, 65535], [0, 30000, 65535])
    ed.apply(teditor.FULL)
    return ed


def _pack_counts():
    before = dict(tparams.COUNTS)
    return lambda: {k: tparams.COUNTS[k] - before[k] for k in before}


_EDITS = {
    "curve": lambda ed: ed.set_curve(1, [0, 20000, 65535], [0, 21000, 65535]),
    "tone": lambda ed: ed.set_tone(exposure=0.4, contrast=12),
    "vignette": lambda ed: ed.set_vignette(35),
    "none": lambda ed: None,
}


@pytest.mark.parametrize("edit", sorted(_EDITS))
@pytest.mark.parametrize("n_masks", [3, 0])
def test_an_edit_refits_only_the_curve_it_moved(n_masks, edit):
    ed = _session(n_masks)
    m = n_masks + 1
    done = _pack_counts()
    _EDITS[edit](ed)
    ed.apply(teditor.FULL)
    fits = {"curve": 1, "tone": 0, "vignette": 0, "none": 0}[edit]
    hits = 0 if edit == "none" else 4 * m - fits  # no edit: no pack at all
    assert done() == {"curve_fits": fits, "curve_fit_hits": hits}
    # A render with no edit between reuses the packed curves.
    ed.apply_padded(teditor.FULL)
    assert done() == {"curve_fits": fits, "curve_fit_hits": hits}


def test_a_mask_with_more_points_refits_every_curve():
    ed = _session(3)
    done = _pack_counts()
    hw = ed.shape
    ed.add_mask("wide", np.ones(hw, np.float32))
    # Five points pad the segments from 4 to 8: every curve's fit changes.
    ed.set_curve(2, [0, 9000, 30000, 50000, 65535],
                 [30000, 31000, 34000, 33000, 30000], mask_name="wide")
    ed.apply(teditor.FULL)
    assert done() == {"curve_fits": 4 * 5, "curve_fit_hits": 0}
    ed.set_tone(exposure=-0.3, mask_name="wide")
    ed.apply(teditor.FULL)
    assert done() == {"curve_fits": 4 * 5, "curve_fit_hits": 4 * 5}


def test_points_changed_in_place_are_refitted_not_served_stale():
    params = [tparams.EditParameters() for _ in range(2)]
    params[1].set_curve(0, [0, 30000, 65535], [0, 36000, 65535])
    before = tparams.pack_params(params, build_luts=False, device="cpu")
    params[1].curves[0].control_y[1] -= 9000
    done = _pack_counts()
    warm = tparams.pack_params(params, build_luts=False, device="cpu")
    assert done() == {"curve_fits": 1, "curve_fit_hits": 7}
    fresh = [tparams.EditParameters.from_json(p.to_json()) for p in params]
    cold = tparams.pack_params(fresh, build_luts=False, device="cpu")
    assert torch.equal(warm.breaks, cold.breaks)
    assert torch.equal(warm.coeffs, cold.coeffs)
    assert not torch.equal(warm.coeffs, before.coeffs)


def test_a_raw_lut_curve_is_fitted_every_pack():
    p = tparams.EditParameters()
    p.set_curve(tparams.HUE, raw_lut=np.arange(65536, dtype=np.int32) // 2)
    packs = [tparams.pack_params([p], build_luts=False, device="cpu")
             for _ in range(2)]
    done = _pack_counts()
    tparams.pack_params([p], build_luts=False, device="cpu")
    tparams.pack_params([p], build_luts=False, device="cpu")
    assert done() == {"curve_fits": 2, "curve_fit_hits": 6}
    assert torch.equal(packs[0].coeffs, packs[1].coeffs)


def test_geometry_reruns_the_warp_and_the_unsharp_on_either_slider():
    ed = _session(1)
    ed.set_lens_distortion(20)
    ed.set_sharpness(40)
    ed.apply(teditor.FULL)
    before = dict(teditor.COUNTS)

    def done():
        return {k: teditor.COUNTS[k] - before[k] for k in before}

    ed.set_lens_distortion(-15)
    ed.apply(teditor.FULL)
    ed.set_sharpness(70)
    ed.apply(teditor.FULL)
    assert done() == {"warps": 2, "unsharps": 2}
    ed.set_tone(exposure=0.4)
    ed.apply(teditor.FULL)
    assert done() == {"warps": 2, "unsharps": 2}


def test_a_dng_open_records_each_stage_once():
    from rawphotoforge_tpu_torch.io.dng import write_dng
    from rawphotoforge_tpu_torch.io.raw import synthetic_raw

    rng = np.random.default_rng(9)
    raw = synthetic_raw(rng.random((3, 100, 132)).astype(np.float32) * 0.8)
    data = write_dng(raw, compression=7, tile=(64, 64))
    with profiling.span_log() as log:
        ed = teditor.PhotoEditor.from_bytes(data, "DNG", device="cpu")
    assert ed.shape == (100, 132)
    names = [n for n, _, _, _ in log]
    assert sorted(names) == ["open.instant", "open.ljpeg", "open.pad"]
    assert all(a <= b for _, _, a, b in log)
