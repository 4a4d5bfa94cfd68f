"""The instant era of an async /open on both servers, on the CPU: each
server's device phase is gated (the ``gated_server`` monkeypatch of
tests/test_instant.py, on both packages' ``PhotoEditor.from_host``), so the
era's contract is asserted request by request against the JAX server.

During the era both serve host renders (engine/hostdev through the native
library, bit for bit the same on both sides), so previews, histograms and
JSON bodies are equal byte for byte. Era edits, crop, reset, presets and
similarity / smart / model masks replay in order at the swap; after it the
device sessions' previews agree within the decoded bound (or, past it, on
the renders before the JPEG). Also: a device-phase failure that rolls back,
the instant startup, ``open_host`` + ``from_host`` against
``from_bytes``, and a concurrency soak of the port's server."""

import io
import json
import threading

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.app import server as jserver
from rawphotoforge_tpu.engine import segmenter as jseg
from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor
from rawphotoforge_tpu.engine.session import Settings as JSettings
from rawphotoforge_tpu.io import dng as jdng, raw as jraw

from rawphotoforge_tpu_torch.app import server as tserver
from rawphotoforge_tpu_torch.engine import segmenter as tseg
from rawphotoforge_tpu_torch.engine.editor import MID, PhotoEditor as TEditor
from rawphotoforge_tpu_torch.engine.session import Settings as TSettings

from conftest import random_linear_image
from torch_server_pair import Pair, capture_renders, request, start


def _png_bytes(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _disk(rgb_u8, point_xy, labels=None, radius=6):
    """A segmenter stub: a disk around the (first) prompt point."""
    h, w = rgb_u8.shape[:2]
    x, y = point_xy[0] if isinstance(point_xy, list) else point_xy
    yy, xx = np.mgrid[0:h, 0:w]
    return np.where((xx - x) ** 2 + (yy - y) ** 2 <= radius ** 2, 1.0, -1.0)


def _servers(monkeypatch, tmp_path, from_host=None, editor=True, initial=None,
             segmenter=False):
    """Both servers, each device phase running ``from_host`` (a wrapper of
    the real one, given the class and the real function) when given."""
    for cls in (JEditor, TEditor):
        if from_host is not None:
            real = cls.from_host.__func__
            monkeypatch.setattr(cls, "from_host", classmethod(
                lambda c, ho, _real=real, **kw: from_host(c, ho, _real, **kw)))
    rng = np.random.default_rng(42)
    img = random_linear_image(rng, 30, 40)
    jed = (JEditor.from_rgb_f32(img, mid_long_edge=24, use_pallas=False)
           if editor else None)
    ted = (TEditor.from_rgb_f32(img, mid_long_edge=24, use_kernel=False,
                                device="cpu") if editor else None)
    jh = jserver.serve(jed, port=0, settings=JSettings(),
                       settings_path=str(tmp_path / "j.json"), prewarm=False,
                       initial_file=initial,
                       segmenter=jseg.make_segmenter(_disk) if segmenter else None)
    th = tserver.serve(ted, port=0, settings=TSettings(),
                       settings_path=str(tmp_path / "t.json"), prewarm=False,
                       initial_file=initial, device="cpu",
                       segmenter=tseg.make_segmenter(_disk) if segmenter else None)
    return jh, th


@pytest.fixture()
def gated(monkeypatch, tmp_path):
    gate = threading.Event()

    def gated_from_host(cls, ho, real, **kw):
        gate.wait(timeout=120)
        return real(cls, ho, **kw)

    renders = capture_renders(monkeypatch)
    jh, th = _servers(monkeypatch, tmp_path, gated_from_host, segmenter=True)
    yield Pair(start(jh), start(th), renders), gate
    gate.set()
    jh.shutdown()
    th.shutdown()


def _same_bytes(pair, path):
    j, t = pair.both(path)
    assert j[0] == 200 and j[2] == t[2], path
    for k in ("X-RPF-Instant", "X-RPF-HostDrag"):
        assert j[1].get(k) == t[1].get(k), (path, k)
    return t


def _open(pair, data, name="pic.png"):
    out, status = pair.same_json(f"/open?name={name}", raw=data)
    assert status == 200 and out["instant"], out


def test_era_previews_edits_and_swap(gated):
    pair, gate = gated
    _open(pair, _png_bytes(np.random.default_rng(33), 36, 54))
    t = _same_bytes(pair, "/preview?level=mid")
    assert t[1]["X-RPF-Instant"] == "1"
    for path in ("/histogram", "/info", "/exif", "/open/status", "/masks",
                 "/params", "/preset", "/settings"):
        pair.same_json(path)
    pair.same_json("/edit", {"exposure": 2.0, "contrast": 20,
                             "curve_hue": [[0, 8000], [30000, 35000], [65535, 62000]]})
    for path in ("/preview?level=mid", "/preview?level=low",
                 "/preview?level=mid&rect=0.25,0.25,0.75,0.75",
                 "/preview?original=1"):
        _same_bytes(pair, path)
    for path in ("/histogram", "/histogram?drag=1", "/params"):
        pair.same_json(path)
    pair.same_json("/edit", {"exposur": 1.0})          # 400 on both
    pair.same_json("/export/start", {"fmt": "jpeg"})   # 409 until the swap
    pair.same_json("/export/status?job=nope")          # 400 through the era
    pair.same_json("/settings", {"locale": "ja"})      # session-global
    pair.same_json("/edit", {"exposure": 1.5, "sharpness": 30})  # replaces
    gate.set()
    pair.wait_ready()
    for path in ("/params", "/info", "/masks", "/preset", "/open/status"):
        pair.same_json(path)
    params, _ = pair.same_json("/params")
    assert params["exposure"] == 1.5 and params["sharpness"] == 30
    j, t = pair.same_image("/preview?level=mid")
    assert "X-RPF-Instant" not in t[1]
    pair.same_image("/preview?level=low")


def test_era_crop_reset_and_preset(gated):
    pair, gate = gated
    _open(pair, _png_bytes(np.random.default_rng(53), 40, 80))
    pristine = _same_bytes(pair, "/preview?level=mid")[2]
    pair.same_json("/crop", {"x0": 20, "y0": 10, "x1": 60, "y1": 30})
    _same_bytes(pair, "/preview?level=mid")
    pair.same_json("/info")
    pair.same_json("/reset", {})
    assert _same_bytes(pair, "/preview?level=mid")[2] == pristine
    pair.same_json("/preset", {"version": 1, "crop": [4, 4, 70, 36],
                               "masks": [{"name": "main", "params": {
                                   "exposure": -0.5, "contrast": 40}}]})
    _same_bytes(pair, "/preview?level=mid")
    pair.same_json("/preset", {"exposure": 0.7})       # the v1 flat schema
    pair.same_json("/preset")
    pair.same_json("/preset", {"masks": "nope"})       # 400 on both
    gate.set()
    pair.wait_ready()
    for path in ("/params", "/info", "/preset"):
        pair.same_json(path)
    pair.same_image("/preview?level=mid")


def test_era_masks_replay_in_order(gated):
    pair, gate = gated
    _open(pair, _png_bytes(np.random.default_rng(79), 40, 60))
    pair.same_json("/mask/add", {"name": "sim", "point": [30, 20], "tolerance": 0.4})
    pair.same_json("/mask/add", {"name": "smart", "point": [10, 10], "smart": True,
                                 "tolerance": 0.6})
    pair.same_json("/mask/add", {"name": "pts", "points": [[5, 5], [50, 30]],
                                 "labels": [1, 0]})
    pair.same_json("/mask/add", {"name": "dog", "point": [30, 20], "model": True})
    pair.same_json("/mask/add", {"name": "evil", "point": [1, 1],
                                 "model": "rm -rf /"})  # 400: no specs over HTTP
    pair.same_json("/edit", {"_target": "sim", "exposure": 1.0})
    pair.same_json("/mask/invert", {"name": "smart"})
    pair.same_json("/mask/remove", {"name": "pts"})
    for path in ("/preview?level=mid", "/preview?level=low",
                 "/preview?level=mid&overlay=dog"):
        _same_bytes(pair, path)
    pair.same_json("/masks")
    pair.same_json("/params?mask=sim")
    gate.set()
    pair.wait_ready()
    names, _ = pair.same_json("/masks")
    assert names == ["main", "sim", "smart", "dog"]
    pair.same_json("/params?mask=sim")
    pair.same_image("/preview?level=mid")
    pair.same_image("/preview?level=mid&overlay=dog")


def test_device_phase_failure_rolls_back(monkeypatch, tmp_path):
    def boom(cls, ho, real, **kw):
        raise RuntimeError("device exploded")

    jh, th = _servers(monkeypatch, tmp_path, boom)
    pair = Pair(start(jh), start(th))
    try:
        _open(pair, _png_bytes(np.random.default_rng(47), 36, 54))
        pair.wait_ready()
        st, _ = pair.same_json("/open/status")
        assert st == {"ready": True, "error": "device exploded"}
        info, _ = pair.same_json("/info")
        assert info["shape"] == [30, 40]  # the previous session serves again
        pair.same_json("/edit", {"exposure": 0.5})
        pair.same_image("/preview?level=mid")
    finally:
        jh.shutdown()
        th.shutdown()
    # The instant startup whose device phase fails has no session: 503.
    jh, th = _servers(monkeypatch, tmp_path, boom, editor=False,
                      initial=(_png_bytes(np.random.default_rng(5), 30, 44),
                               "start.png"))
    pair = Pair(start(jh), start(th))
    try:
        pair.wait_ready()
        body, status = pair.same_json("/preview?level=mid")
        assert status == 503 and body["error"] == "device exploded"
        pair.same_json("/edit", {"exposure": 0.5})
        pair.same_json("/settings")
    finally:
        jh.shutdown()
        th.shutdown()


def test_instant_startup(monkeypatch, tmp_path):
    jh, th = _servers(monkeypatch, tmp_path, editor=False,
                      initial=(_png_bytes(np.random.default_rng(59), 30, 44),
                               "start.png"))
    pair = Pair(start(jh), start(th))
    try:
        pair.wait_ready()
        pair.same_json("/info")
        pair.same_json("/edit", {"contrast": 60})
        pair.same_json("/params")
        pair.same_image("/preview?level=mid")
    finally:
        jh.shutdown()
        th.shutdown()


def test_open_host_from_host_equals_from_bytes():
    rng = np.random.default_rng(17)
    data = _png_bytes(rng, 50, 70)
    ho = TEditor.open_host(data, "PNG", mid_long_edge=32)
    jho = JEditor.open_host(data, "PNG", mid_long_edge=32)
    assert ho.shape == jho.shape == (50, 70)
    assert np.array_equal(ho.instant, jho.instant)
    assert np.array_equal(ho.instant_linear, np.asarray(jho.instant_linear))
    a = TEditor.from_host(ho, device="cpu", mid_long_edge=32)
    b = TEditor.from_bytes(data, "PNG", device="cpu", mid_long_edge=32)
    assert torch.equal(a.apply(MID), b.apply(MID))
    assert np.array_equal(a.instant_srgb_u8, ho.instant)
    assert a.instant_preview_jpeg() == JEditor.from_host(
        jho, mid_long_edge=32, use_pallas=False).instant_preview_jpeg()
    assert np.array_equal(a.instant_histogram(), np.asarray(
        JEditor.from_host(jho, mid_long_edge=32, use_pallas=False).instant_histogram()))
    a.set_crop(10, 5, 40, 30)
    assert a.instant_preview_jpeg()[:2] == b"\xff\xd8"


def test_dng_open_host_instant_matches_jax():
    """The superpixel instant preview of a RAW (io/raw.decode_raw_host) and
    of a PPM16 (io/image_io.decode_image_host) equal the JAX package's."""
    rng = np.random.default_rng(23)
    planes = 0.8 * rng.random((3, 64, 96), dtype=np.float32)
    data = jdng.write_dng(jraw.synthetic_raw(planes, pattern="RGGB"))
    ho = TEditor.open_host(data, "DNG", mid_long_edge=40)
    jho = JEditor.open_host(data, "DNG", mid_long_edge=40)
    assert ho.shape == jho.shape
    assert np.array_equal(ho.instant, jho.instant)
    assert np.array_equal(ho.instant_linear, jho.instant_linear)
    from rawphotoforge_tpu.io import image_io as jio
    from rawphotoforge_tpu_torch.io import image_io as tio

    u16 = (rng.random((20, 30, 3)) * 65535).astype(np.uint16)
    ppm = jio.encode_ppm16(u16)
    a = tio.decode_image_host(ppm, "PPM16", instant_long_edge=16)
    b = jio.decode_image_host(ppm, "PPM16", instant_long_edge=16)
    assert np.array_equal(a.instant, b.instant)
    out = {"long_edge": 16}
    tio.decode_image(ppm, "PPM16", device="cpu", instant_out=out)
    assert np.array_equal(out["srgb_u8_hwc"], b.instant)


def test_port_server_concurrent_soak_across_era_transitions(monkeypatch, tmp_path):
    """tests/test_instant.py's soak on the port's server: worker threads (more
    than this machine's cores, a short switch interval) fire random requests,
    host drag ticks among them, while /open era transitions (start, swap,
    supersede, rollback) churn. Every response is a status of the contract,
    none hangs or drops, and the server ends editable."""
    import os
    import sys
    import time
    import urllib.error
    import urllib.request

    real = TEditor.from_host.__func__

    def slow_from_host(cls, ho, **kw):
        time.sleep(0.05)
        if ho.shape == (21, 27):  # one shape fails: the rollback path
            raise RuntimeError("boom")
        return real(cls, ho, **kw)

    monkeypatch.setattr(TEditor, "from_host", classmethod(slow_from_host))
    rng = np.random.default_rng(241)
    ed = TEditor.from_rgb_f32(random_linear_image(rng, 30, 40), mid_long_edge=24,
                              low_long_edge=12, device="cpu")
    httpd = tserver.serve(ed, port=0, settings=TSettings(),
                          settings_path=str(tmp_path / "s.json"), prewarm=False)
    base = start(httpd)
    pngs = {shape: _png_bytes(rng, *shape) for shape in ((20, 26), (21, 27), (24, 30))}
    errors = []
    ok = {200, 204, 400, 404, 409, 503}

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(30):
            roll = int(r.integers(0, 11))
            if roll == 0:
                shape = list(pngs)[int(r.integers(0, 3))]
                code = request(base, f"/open?name=f{shape[0]}.png", raw=pngs[shape])[0]
            elif roll < 4:
                code = request(base, "/edit", {"exposure": float(r.uniform(-2, 2))})[0]
            elif roll == 4:
                code = request(base, "/crop", {"x0": 1, "y0": 1, "x1": 15, "y1": 12})[0]
            elif roll == 5:
                code = request(base, "/reset", {})[0]
            elif roll == 6:
                code = request(base, "/preview?level=mid")[0]
            elif roll == 7:
                code = request(base, "/preview?level=low")[0]
            elif roll == 8:
                code = request(base, "/histogram?drag=1")[0]
            elif roll == 9:
                code = request(base, "/params?mask=main")[0]
            else:
                code = request(base, "/open/status")[0]
            if code not in ok:
                errors.append(f"unexpected status {code}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(300 + i,))
                   for i in range(max(4, (os.cpu_count() or 1) + 1))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
            assert not th.is_alive(), "soak worker hung"
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors[:5]
        Pair(base, base).wait_ready(60)
        assert request(base, "/edit", {"exposure": 0.5})[0] == 200
        assert request(base, "/preview?level=mid")[0] == 200
        status, headers, _ = request(base, "/preview?level=low")
        assert status == 200 and headers.get("X-RPF-HostDrag") == "1"
    finally:
        httpd.shutdown()
