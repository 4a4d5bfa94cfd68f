"""The port's preview server (app/server.py) against the JAX package's, on
the CPU: the same seeded 60x90 image (MID 48, LOW 24, as
tests/test_server.py) behind both servers and one scripted request
sequence sent to both. Status codes and JSON bodies are equal; the X-RPF
headers are present on the same responses; JPEG previews and exports
decode within the bound of tests/test_torch_batch.py (at most 3 u8
levels, at most 1.5 % of samples more than 1 apart), and histograms keep
the same counts within that bound (``assert_hist_close``). Both sides
render with the exact-LUT anchor, as the JAX package's own server tests do
(``use_pallas=False``, the port's ``use_kernel=False``; the kernel path's
own distance from the anchor is held in tests/test_torch_editor.py), the
port on ``device="cpu"``."""

import json
import time

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.app.server import serve as jserve
from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor
from rawphotoforge_tpu.engine.session import Settings as JSettings

from rawphotoforge_tpu_torch.app import server as tserver
from rawphotoforge_tpu_torch.engine.editor import LOW, PhotoEditor as TEditor
from rawphotoforge_tpu_torch.engine.session import Settings as TSettings

from conftest import random_linear_image
from torch_parity import nongray_image
from torch_server_pair import (Pair, assert_hist_close, assert_images_close,
                               capture_renders, decode, start)


def _image():
    return nongray_image(np.random.default_rng(42), 60, 90)


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    renders = capture_renders(monkeypatch)
    img = _image()
    jed = JEditor.from_rgb_f32(img, use_pallas=False, mid_long_edge=48,
                               low_long_edge=24)
    ted = TEditor.from_rgb_f32(img, device="cpu", mid_long_edge=48,
                               low_long_edge=24, use_kernel=False)
    jh = jserve(jed, port=0, settings=JSettings(),
                settings_path=str(tmp_path / "j.json"), prewarm=False)
    th = tserver.serve(ted, port=0, settings=TSettings(),
                       settings_path=str(tmp_path / "t.json"), prewarm=False)
    yield Pair(start(jh), start(th), renders)
    jh.shutdown()
    th.shutdown()


CURVES = {"curve_brightness": [[0, 0], [30000, 36000], [65535, 65535]],
          "curve_hue": [[0, 8000], [30000, 35000], [65535, 62000]]}


def test_page_previews_and_edits(pair):
    (j, t) = pair.both("/")
    assert j[0] == 200 and "text/html" in t[1]["Content-Type"] and j[2] == t[2]
    for level in ("low", "mid", "full"):
        pair.same_image(f"/preview?level={level}")
        pair.same_image(f"/preview?level={level}&rect=0.1,0.2,0.6,0.9")
        pair.same_image(f"/preview?level={level}&original=1")
    j, t = pair.both("/preview?level=low")
    assert j[1]["X-RPF-HostDrag"] == t[1]["X-RPF-HostDrag"] == "1"
    assert len(t[1]["X-RPF-Drag-Us"].split(",")) == 3
    pair.same_json("/edit", {"exposure": 0.6, "contrast": 25, "shadow": 10,
                             "wb_temperature": 20, "vignette": 30,
                             "sharpness": 20, **CURVES})
    for level in ("low", "mid", "full"):
        pair.same_image(f"/preview?level={level}")
    for path in ("/params", "/params?mask=main", "/info", "/masks", "/exif",
                 "/settings", "/preset"):
        pair.same_json(path)
    j, t = pair.both("/histogram")
    assert_hist_close(json.loads(j[2]), json.loads(t[2]), "/histogram")
    j, t = pair.both("/histogram?drag=1")
    assert_hist_close(json.loads(j[2]), json.loads(t[2]), "/histogram?drag=1")
    pair.same_json("/edit", {"lens_distortion": 40, "exposure": 0.2})
    pair.same_image("/preview?level=mid")
    pair.same_image("/preview?level=low")
    j, t = pair.both("/nope")
    assert j[0] == 404


def test_masks_regional_edit_and_overlay(pair):
    pair.same_json("/mask/add", {"name": "sim", "point": [20, 30], "tolerance": 0.3})
    pair.same_json("/mask/add", {"name": "smart", "point": [70, 40], "smart": True,
                                 "tolerance": 0.5})
    pair.same_json("/mask/add", {"name": "pts", "points": [[10, 10], [80, 50]],
                                 "labels": [1, 0], "tolerance": 0.2})
    pair.same_json("/mask/add", {"name": "spts", "points": [[10, 10], [80, 50]],
                                 "labels": [1, 0], "smart": True})
    data = np.zeros((60, 90), np.float32)
    data[10:40, 20:70] = 1.0
    pair.same_json("/mask/add", {"name": "data", "data": data.tolist()})
    names, _ = pair.same_json("/masks")
    assert names == ["main", "sim", "smart", "pts", "spts", "data"]
    pair.same_json("/edit", {"_target": "data", "exposure": 1.0, "contrast": 30})
    pair.same_json("/edit", {"_target": "sim", "exposure": -0.5, **CURVES})
    pair.same_json("/params?mask=data")
    for level in ("low", "mid", "full"):
        pair.same_image(f"/preview?level={level}")
    pair.same_image("/preview?level=mid&overlay=data")
    pair.same_json("/mask/invert", {"name": "data"})
    pair.same_json("/mask/remove", {"name": "pts"})
    pair.same_json("/edit", {"mask_range": 0.2})
    pair.same_image("/preview?level=mid")
    pair.same_image("/preview?level=low")
    pair.same_json("/masks")
    pair.same_json("/preset")
    pair.same_json("/reset", {})
    pair.same_json("/masks")


def test_crop_preset_and_settings(pair):
    pair.same_json("/crop", {"x0": 10, "y0": 5, "x1": 70, "y1": 50})
    pair.same_json("/info")
    for level in ("low", "mid", "full"):
        pair.same_image(f"/preview?level={level}")
    j, t = pair.both("/histogram")
    assert_hist_close(json.loads(j[2]), json.loads(t[2]), "cropped /histogram")
    pair.same_json("/crop", {"clear": True})
    # The masks schema (crop included), then the reference v1 flat schema.
    preset = {"version": 1, "crop": [0, 0, 45, 30],
              "masks": [{"name": "main", "params": {"exposure": 0.4,
                                                    "contrast": 15}}]}
    pair.same_json("/preset", preset)
    pair.same_json("/preset")
    pair.same_json("/info")
    pair.same_image("/preview?level=mid")
    pair.same_json("/preset", {"exposure": -0.3, "contrast": 10,
                               "brightness_curve_points": [[0, 0], [40000, 30000],
                                                           [65535, 65535]]})
    pair.same_json("/params")
    pair.same_image("/preview?level=mid")
    pair.same_json("/settings", {"locale": "ja", "jpeg_quality": 80})
    j, t = pair.both("/")
    assert j[2] == t[2]  # the page in Japanese
    pair.same_json("/settings", {"locale": "en"})


def test_exports_sync_and_async(pair):
    pair.same_json("/edit", {"exposure": 0.3, "contrast": 10, **CURVES})
    for fmt in ("jpeg", "png", "webp", "tiff"):
        j, t = pair.same_image(f"/export?fmt={fmt}")
        assert j[1]["Content-Type"] == t[1]["Content-Type"]
    j, t = pair.both("/export?fmt=dng")
    assert j[0] == 200 and t[2][:4] in (b"II*\x00", b"MM\x00*")
    jobs = {}
    for fmt in ("jpeg", "png", "dng"):
        out, _ = pair.same_json("/export/start", {"fmt": fmt})
        jobs[fmt] = out["job"]
    for fmt, job in jobs.items():
        for base in (pair.jbase, pair.tbase):
            deadline = time.monotonic() + 120
            while True:
                from torch_server_pair import request

                st = json.loads(request(base, f"/export/status?job={job}")[2])
                if st["state"] != "running":
                    break
                assert time.monotonic() < deadline
                time.sleep(0.05)
            assert st["state"] == "done" and st["fmt"] == fmt.upper(), st
            assert set(st["stages_ms"]) >= {"render", "fetch", "encode"}
        j, t = pair.both(f"/export/result?job={job}")
        assert j[0] == 200 and j[1]["Content-Type"] == t[1]["Content-Type"]
        if fmt == "png":
            # Lossless: the two exports decode within the render bound.
            assert_images_close(j[2], t[2], f"async {fmt}")
        elif fmt == "jpeg":
            assert decode(j[2]).shape == decode(t[2]).shape
    pair.same_json("/export/status?job=99")


@pytest.mark.parametrize("path,raw", [
    ("/edit", b"{not json"),
    ("/edit", b'{"exposur": 1.0}'),
    ("/edit", b'{"curve_hue": {"x": [0, 65535], "y": [0, 65535]}}'),
    ("/edit", b'{"curve_brightness": [[0, 0], [0, 10], [65535, 65535]]}'),
    ("/mask/add", b'{"name": "m", "point": [1, 1], "colour": 1}'),
    ("/mask/add", b'{"name": "m", "point": [1, 1], "model": "rm -rf /"}'),
    ("/mask/remove", b'{"name": "nope"}'),
    ("/crop", b'{"x0": 0, "y0": 0, "x1": 10, "y1": 10, "z": 1}'),
    ("/crop", b'{"x0": 5, "y0": 5, "x1": 5, "y1": 9}'),
    ("/reset", b'{"hard": true}'),
    ("/export/start", b'{"fmt": "bmp"}'),
    ("/settings", b'{"theme": "dark"}'),
    ("/preset", b'{"masks": [{"name": "main", "params": {"curves": '
                b'{"brightness": {"x": [0, 0], "y": [0, 1]}}}}]}'),
])
def test_malformed_and_unknown_key_bodies(pair, path, raw):
    body, status = pair.same_json(path, raw=raw)
    assert status == 400 and "error" in body


def test_bad_rect_headers_and_cross_origin(pair):
    body, status = pair.same_json("/preview?level=mid&rect=0.5,0.5,0.2,0.9")
    assert status == 400
    j, t = pair.both("/edit", raw=b"{}", headers={"Origin": "http://evil.example"})
    assert j[0] == 403 and json.loads(j[2]) == json.loads(t[2])
    j, t = pair.both("/edit", raw=b"{}", headers={"Content-Length": "x"})
    assert j[0] == 400


def test_hostdrag_cache_keys_on_the_mask_stack_identity(tmp_path):
    """The drag cache fetches the LOW original and mask stack once and
    keys on tensor identity: ``_masks_at(LOW)`` returns the same tensor
    until the masks change, and a new one after."""
    ed = TEditor.from_rgb_f32(random_linear_image(np.random.default_rng(3), 40, 60),
                              device="cpu", mid_long_edge=32, low_long_edge=16)
    ed.add_mask("m", np.where(np.arange(60)[None, :] < 30, 1.0, -1.0)
                * np.ones((40, 1), np.float32))
    app = tserver.EditorApp(ed, settings=TSettings(),
                            settings_path=str(tmp_path / "s.json"), prewarm=False)
    first = ed._masks_at(LOW)
    assert ed._masks_at(LOW) is first
    u8 = app._hostdrag_frame()
    cache = app._hostdrag_cache
    ed.set_tone(exposure=0.5)  # a slider edit re-renders, never re-fetches
    assert ed._masks_at(LOW) is first
    u8b = app._hostdrag_frame()
    assert app._hostdrag_cache is cache and not np.array_equal(u8, u8b)
    ed.invert_mask("m")  # a mask change rebuilds the stack and the cache
    assert ed._masks_at(LOW) is not first
    app._hostdrag_frame()
    assert app._hostdrag_cache is not cache


def test_device_rule_and_host_drag_fallback(tmp_path, capsys):
    """serve() without a device needs a card; a failing host drag falls
    back to the session's device render and says so once."""
    if not torch.cuda.is_available():
        from rawphotoforge_tpu_torch._errbase import PhotoEditorError

        with pytest.raises(PhotoEditorError, match="no CUDA device"):
            tserver.serve(None, port=0, settings=TSettings(),
                          settings_path=str(tmp_path / "s.json"), prewarm=False)
    ed = TEditor.from_rgb_f32(_image(), device="cpu", mid_long_edge=48,
                              low_long_edge=24)
    app = tserver.EditorApp(ed, settings=TSettings(),
                            settings_path=str(tmp_path / "s.json"), prewarm=False)
    assert app.device == torch.device("cpu")

    def broken():
        raise RuntimeError("host drag broke")

    app._hostdrag_frame = broken
    for _ in range(2):
        jpeg, host = app.preview_jpeg(LOW)
        assert not host and jpeg[:2] == b"\xff\xd8"
    assert capsys.readouterr().err.count("host-drag render failed") == 1
    assert app.drag_histogram() is None
