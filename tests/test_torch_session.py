"""engine/session (Settings, select_device), app/translations, the
engine/prewarm analog and the CLI's serve / device rule of the port,
against the JAX package where both have the surface."""

import json

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.app import translations as jtr
from rawphotoforge_tpu.engine import prewarm as jpw
from rawphotoforge_tpu.engine import session as jsession

from rawphotoforge_tpu_torch._errbase import PhotoEditorError
from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.app import translations as ttr
from rawphotoforge_tpu_torch.engine import prewarm as tpw
from rawphotoforge_tpu_torch.engine import session as tsession
from rawphotoforge_tpu_torch.engine.editor import PhotoEditor

from conftest import random_linear_image


def test_settings_round_trip_and_clamp_match_jax(tmp_path):
    path = str(tmp_path / "sub" / "settings.json")
    s = tsession.Settings(ui_preview_size=900, drag_preview_size=300,
                          locale="ja", device_index=2, jpeg_quality=80)
    s.save(path)
    assert tsession.Settings.load(path) == s
    assert jsession.Settings.load(path).to_json() == s.to_json()
    for d in ({"ui_preview_size": 99999, "drag_preview_size": -5, "locale": "fr",
               "jpeg_quality": "x", "device_index": -3, "unknown": 1},
              {"ui_preview_size": "big", "drag_preview_size": None},
              {}):
        assert (tsession.Settings.from_json(dict(d)).to_json()
                == jsession.Settings.from_json(dict(d)).to_json())


@pytest.mark.parametrize("content", ["[1, 2]", "not json", '"str"', "null", "{"])
def test_settings_load_tolerates_garbage(tmp_path, content):
    p = tmp_path / "s.json"
    p.write_text(content)
    assert tsession.Settings.load(str(p)) == tsession.Settings()
    assert tsession.Settings.load(str(tmp_path / "missing.json")) == tsession.Settings()


def test_default_settings_path_matches_jax(monkeypatch, tmp_path):
    assert tsession.default_settings_path() == jsession.default_settings_path()
    monkeypatch.setenv("RPF_SETTINGS", str(tmp_path / "x.json"))
    assert tsession.default_settings_path() == str(tmp_path / "x.json")


def test_select_device(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(PhotoEditorError, match="no CUDA device"):
            tsession.Settings().select_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsession.Settings(device_index=1).select_device() == torch.device("cuda:1")
    assert tsession.Settings(device_index=0).select_device() == torch.device("cuda:0")
    assert tsession.Settings(device_index=5).select_device() is None


def test_translations_equal_jax():
    assert ttr.TRANSLATIONS == jtr.TRANSLATIONS
    assert ttr.EXIF_LABELS == jtr.EXIF_LABELS
    for loc in ("en", "ja", "fr", None):
        assert ttr.tr(loc) == jtr.tr(loc)
        assert ttr.exif_labels(loc) == jtr.exif_labels(loc)


def test_prewarm_shapes_equal_jax():
    assert tpw.STANDARD_ASPECTS == jpw.STANDARD_ASPECTS
    assert tpw.CANONICAL_SENSOR_SHAPES == jpw.CANONICAL_SENSOR_SHAPES
    assert tpw.XTRANS_SENSOR_SHAPES == jpw.XTRANS_SENSOR_SHAPES
    for mid, low in ((1280, 400), (500, 100), (2000, 800), (777, 333)):
        assert tpw.preview_shapes(mid, low) == jpw.preview_shapes(mid, low)


def test_warm_async_builds_and_renders_the_levels(capsys):
    import threading

    ed = PhotoEditor.from_rgb_f32(random_linear_image(np.random.default_rng(1), 40, 60),
                                  device="cpu", mid_long_edge=32, low_long_edge=16)
    lock = threading.Lock()
    t = tpw.warm_async(lock, editor=ed)
    t.join(timeout=120)
    assert not t.is_alive() and set(ed._rendered) == {"mid", "low"}
    assert capsys.readouterr().err == ""
    # A build failure is reported, never raised from the thread, and met
    # again by the caller's next use.
    from rawphotoforge_tpu_torch import native

    def failed():
        raise native.NativeBuildError("building rpf_native.cpp failed")

    real = native.library
    native.library = failed
    try:
        ed.set_tone(exposure=0.3)
        t = tpw.warm_async(lock, editor=ed)
        t.join(timeout=120)
        assert not t.is_alive() and ed._rendered == {}
        assert "prewarm failed (NativeBuildError" in capsys.readouterr().err
    finally:
        native.library = real
    assert tpw.server_libraries(torch.device("cpu")) == (native,)
    assert len(tpw.server_libraries(torch.device("cuda"))) == 5


def test_build_async_builds_the_sessions_kernels_on_a_card_only(monkeypatch, capsys):
    """An editor's open starts the build of the develop and geometry
    libraries on a thread of its own before the host decode; off a card it
    starts nothing. A failed build is reported, never raised there."""
    from rawphotoforge_tpu_torch.kernels import fused, geometry

    assert tpw.session_libraries(torch.device("cpu")) == ()
    assert tpw.build_async(torch.device("cpu")) is None
    assert tpw.session_libraries(torch.device("cuda")) == (fused, geometry)
    built = []

    class Lib:
        def __init__(self, name, fail=False):
            self.name, self.fail = name, fail

        def library(self):
            if self.fail:
                raise RuntimeError(f"nvcc failed for {self.name}")
            built.append(self.name)

    monkeypatch.setattr(tpw, "session_libraries", lambda d: (Lib("a"), Lib("b")))
    t = tpw.build_async(torch.device("cuda"))
    t.join(timeout=60)
    assert not t.is_alive() and sorted(built) == ["a", "b"]
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(tpw, "session_libraries", lambda d: (Lib("c", fail=True),))
    t = tpw.build_async(torch.device("cuda"))
    t.join(timeout=60)
    assert "kernel build failed (RuntimeError: nvcc failed for c)" in capsys.readouterr().err
    opened = []
    monkeypatch.setattr(tpw, "build_async", opened.append)
    img = random_linear_image(np.random.default_rng(2), 20, 30)
    from rawphotoforge_tpu_torch.io import image_io

    PhotoEditor.from_bytes(image_io.encode_ppm16(img), "PPM16", device="cpu")
    assert opened == [torch.device("cpu")]


def test_cli_serve_help(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["serve", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--port", "--device", "--no-host-drag", "--segmenter",
                 "--lens-correct", "--lens-db"):
        assert flag in out


def _ppm(tmp_path):
    from rawphotoforge_tpu_torch.io import image_io

    u16 = (np.random.default_rng(2).random((24, 36, 3)) * 65535).astype(np.uint16)
    p = tmp_path / "in.ppm"
    p.write_bytes(image_io.encode_ppm16(u16))
    return str(p)


def test_cli_develop_and_batch_honor_device_over_settings(tmp_path, monkeypatch, capsys):
    """--device wins over the settings' device_index; without --device the
    settings pick the card, and with no card that is an error (exit 2)."""
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({"device_index": 3}))
    monkeypatch.setenv("RPF_SETTINGS", str(settings))
    src = _ppm(tmp_path)
    out = str(tmp_path / "out.png")
    assert tcli.main(["develop", src, out, "--device", "cpu", "--exposure", "0.3"]) == 0
    assert "on cpu" in capsys.readouterr().out
    (tmp_path / "in_dir").mkdir()
    (tmp_path / "in_dir" / "a.ppm").write_bytes(open(src, "rb").read())
    assert tcli.main(["batch", str(tmp_path / "in_dir"), str(tmp_path / "o"),
                      "--device", "cpu"]) == 0
    assert (tmp_path / "o" / "a.jpg").exists()
    if not torch.cuda.is_available():
        capsys.readouterr()
        assert tcli.main(["develop", src, out]) == 2
        assert "no CUDA device" in capsys.readouterr().err
        assert tcli.main(["batch", str(tmp_path / "in_dir"), str(tmp_path / "o")]) == 2
    # The settings' card is what the command resolves without --device.
    picked = []
    monkeypatch.setattr(tsession.Settings, "select_device",
                        lambda self: picked.append(self.device_index) or None)
    monkeypatch.setattr(tcli, "resolve_device",
                        lambda d: torch.device("cpu") if d is None else torch.device(d))
    assert tcli.main(["develop", src, out]) == 0
    assert picked == [3]
