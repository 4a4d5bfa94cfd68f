"""The port's external segmenter adapters (``engine/segmenter``) with stub
models — a callable, a Python script writing ``.npy``, a TorchScript module
saved to ``tmp_path`` — and their typed errors, as the JAX package's
``tests/test_segmenter.py`` runs them (no weights ship). The resample to the
image size is held against the JAX package's ``segment_to_mask`` on the same
logits (within 1e-6: the same bilinear arithmetic in f32)."""

import sys
import textwrap

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.engine import segmenter as jseg

from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
from rawphotoforge_tpu_torch.engine.segmenter import (
    CallableSegmenter, SegmenterError, SubprocessSegmenter, TorchScriptSegmenter,
    make_segmenter, segment_to_mask)

from conftest import random_linear_image

KW = dict(mid_long_edge=32, low_long_edge=16)


def _disk_stub(rgb_u8, point_xy, radius=6):
    """Stub model: logits 1 inside a disk around the click, else -1."""
    h, w = rgb_u8.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    x, y = point_xy
    return np.where((xx - x) ** 2 + (yy - y) ** 2 <= radius ** 2, 1.0, -1.0)


def _u8(rng, h, w):
    return (random_linear_image(rng, h, w) * 255).astype(np.uint8)


def test_callable_adapter_and_resample():
    img = np.zeros((40, 60, 3), dtype=np.uint8)
    seg = CallableSegmenter(lambda im, pt: _disk_stub(im, pt)[::2, ::2])
    logits = segment_to_mask(seg, img, (30, 20), device="cpu")
    assert logits.shape == (40, 60)  # resampled from (20, 30)
    assert logits[20, 30] > 0 and logits[0, 0] < 0


@pytest.mark.parametrize("src_hw", [(20, 30), (13, 47), (40, 60)])
def test_resample_matches_jax(rng, src_hw):
    img = np.zeros((40, 60, 3), dtype=np.uint8)
    src = rng.uniform(-1, 1, src_hw).astype(np.float32)
    fn = lambda im, pt: src  # noqa: E731
    ours = segment_to_mask(CallableSegmenter(fn), img, (3, 4), device="cpu")
    ref = jseg.segment_to_mask(jseg.CallableSegmenter(fn), img, (3, 4))
    assert ours.dtype == np.float32 and ours.shape == (40, 60)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)


def test_subprocess_adapter(tmp_path, rng):
    script = tmp_path / "stubseg.py"
    script.write_text(textwrap.dedent("""\
        import sys
        import numpy as np
        from PIL import Image
        img = np.asarray(Image.open(sys.argv[1]))
        x, y = int(sys.argv[2]), int(sys.argv[3])
        h, w = img.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        np.save(sys.argv[4], ((xx-x)**2 + (yy-y)**2 <= 25).astype(np.float32)*2 - 1)
    """))
    seg = SubprocessSegmenter([sys.executable, str(script)])
    logits = segment_to_mask(seg, _u8(rng, 32, 48), (24, 16), device="cpu")
    assert logits.shape == (32, 48)
    assert logits[16, 24] == 1.0 and logits[0, 0] == -1.0


def test_subprocess_adapter_labeled_points(tmp_path, rng):
    """The multi-point argv: cmd img --points "x,y,l;..." out."""
    script = tmp_path / "stubseg.py"
    script.write_text(textwrap.dedent("""\
        import sys
        import numpy as np
        from PIL import Image
        img = np.asarray(Image.open(sys.argv[1]))
        assert sys.argv[2] == "--points", sys.argv
        h, w = img.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        out = np.full((h, w), -1.0, np.float32)
        for tok in sys.argv[3].split(";"):
            x, y, lab = (int(v) for v in tok.split(","))
            d = (xx - x) ** 2 + (yy - y) ** 2 <= 25
            out = np.where(d, 1.0 if lab else -1.0, out)
        np.save(sys.argv[4], out[None])
    """))
    seg = SubprocessSegmenter([sys.executable, str(script)])
    logits = segment_to_mask(seg, _u8(rng, 32, 48), [(24, 16), (40, 8)],
                             labels=[1, 0], device="cpu")
    assert logits[16, 24] == 1.0 and logits[8, 40] == -1.0


@pytest.mark.parametrize("body,match", [
    ("import sys; sys.exit(3)", "exited 3"),
    ("pass", "no readable logits"),
    ("import sys, numpy as np; np.save(sys.argv[4], np.zeros((2, 3, 4, 5)))",
     "bad logits shape"),
])
def test_subprocess_failures_are_typed(tmp_path, body, match):
    bad = tmp_path / "bad.py"
    bad.write_text(body)
    seg = SubprocessSegmenter([sys.executable, str(bad)])
    with pytest.raises(SegmenterError, match=match):
        seg.segment(np.zeros((8, 8, 3), dtype=np.uint8), (1, 1))
    with pytest.raises(SegmenterError, match="failed"):
        SubprocessSegmenter([str(tmp_path / "missing-binary")]).segment(
            np.zeros((8, 8, 3), dtype=np.uint8), (1, 1))


class _Disk(torch.nn.Module):
    def forward(self, img, pt):
        h, w = img.shape[1], img.shape[2]
        yy = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
        xx = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
        d2 = (xx - pt[0]) ** 2 + (yy - pt[1]) ** 2
        return torch.where(d2 <= 16.0, 1.0, -1.0)


class _Labeled(torch.nn.Module):
    def forward(self, img, pts, labels):
        h, w = img.shape[1], img.shape[2]
        yy = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
        xx = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
        out = torch.full((h, w), -1.0)
        for i in range(pts.shape[0]):
            d2 = (xx - pts[i, 0]) ** 2 + (yy - pts[i, 1]) ** 2
            out = torch.where(d2 <= 16.0, labels[i] * 2.0 - 1.0, out)
        return out[None]


class _Guarded(torch.nn.Module):
    def forward(self, img, pt):
        if pt[0] < 0:
            raise ValueError("point out of bounds")
        return img[0]


def test_torchscript_adapter(tmp_path):
    path = str(tmp_path / "disk.pt")
    torch.jit.script(_Disk()).save(path)
    seg = make_segmenter({"type": "torchscript", "path": path})
    assert isinstance(seg, TorchScriptSegmenter)
    logits = seg.segment(np.zeros((20, 30, 3), dtype=np.uint8), (10, 5))
    assert logits.shape == (20, 30)
    assert logits[5, 10] == 1.0 and logits[19, 29] == -1.0
    lpath = str(tmp_path / "labeled.pt")
    torch.jit.script(_Labeled()).save(lpath)
    two = TorchScriptSegmenter(lpath).segment(
        np.zeros((20, 30, 3), dtype=np.uint8), [(10, 5), (20, 15)], labels=[1, 0])
    assert two[5, 10] == 1.0 and two[15, 20] == -1.0


def test_torchscript_errors_are_typed(tmp_path):
    """A script-level `raise` surfaces as torch.jit.Error, which is not a
    RuntimeError; it still maps to SegmenterError, as does a bad file."""
    path = str(tmp_path / "guarded.pt")
    torch.jit.script(_Guarded()).save(path)
    seg = make_segmenter({"type": "torchscript", "path": path})
    with pytest.raises(SegmenterError, match="failed"):
        seg.segment(np.zeros((8, 8, 3), dtype=np.uint8), (-1, 0))
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"not a module")
    with pytest.raises(SegmenterError, match="cannot load"):
        TorchScriptSegmenter(str(junk))


def test_make_segmenter_specs():
    assert make_segmenter(None) is None
    assert isinstance(make_segmenter(lambda i, p: None), CallableSegmenter)
    assert isinstance(make_segmenter("python seg.py"), SubprocessSegmenter)
    assert make_segmenter('"my tools/seg" --x').cmd == ["my tools/seg", "--x"]
    assert isinstance(make_segmenter(["python", "seg.py"]), SubprocessSegmenter)
    assert make_segmenter({"cmd": ["a"], "timeout": 5.0}).timeout == 5.0
    for spec, match in (({"type": "onnx"}, "unknown"), (42, "cannot build"),
                        ({"type": "subprocess"}, "cmd"),
                        ({"type": "torchscript"}, "path"), ([], "empty")):
        with pytest.raises(SegmenterError, match=match):
            make_segmenter(spec)


def test_bad_logits_shape_is_typed():
    seg = CallableSegmenter(lambda im, pt: np.zeros((2, 3, 4, 5)))
    with pytest.raises(SegmenterError, match="2-D"):
        seg.segment(np.zeros((8, 8, 3), dtype=np.uint8), (0, 0))


def test_callable_adapter_labeled_points(rng):
    def fn(img, points, labels):
        h, w = img.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        out = np.full((h, w), -1.0, np.float32)
        for (x, y), lab in zip(points, labels):
            out = np.where((xx - x) ** 2 + (yy - y) ** 2 <= 16, 1.0 if lab else -1.0, out)
        return torch.from_numpy(out)  # a tensor output is taken too

    seg = CallableSegmenter(fn)
    img = _u8(rng, 24, 32)
    assert segment_to_mask(seg, img, [(8, 8), (8, 8)], labels=[1, 0],
                           device="cpu")[8, 8] == -1.0
    both = segment_to_mask(seg, img, [(8, 8), (24, 12)], labels=[1, 1], device="cpu")
    assert both[8, 8] == 1.0 and both[12, 24] == 1.0


def test_legacy_duck_typed_adapter_still_works(rng):
    class Legacy:
        def segment(self, rgb_u8, point_xy):
            h, w = rgb_u8.shape[:2]
            out = np.full((h, w), -1.0, np.float32)
            out[point_xy[1], point_xy[0]] = 1.0
            return out

    assert segment_to_mask(Legacy(), _u8(rng, 16, 20), (5, 7), device="cpu")[7, 5] == 1.0


def test_editor_add_model_mask(rng):
    ed = PhotoEditor.from_rgb_f32(random_linear_image(rng, 40, 64), device="cpu", **KW)
    ed.set_mask_range(0.5)
    ed.add_model_mask("subject", (32, 20), lambda im, pt: _disk_stub(im, pt))
    mask = ed._find("subject").data_full.numpy()
    assert mask[20, 32] == 1 and mask[0, 0] == 0 and 50 < mask.sum() < 200
    base = ed.apply(FULL).numpy()
    ed.set_tone(exposure=2.0, mask_name="subject")
    out = ed.apply(FULL).numpy()
    assert out[:, 20, 32].mean() > base[:, 20, 32].mean()
    np.testing.assert_allclose(out[:, 0, 0], base[:, 0, 0], atol=1e-6)


def test_editor_model_mask_labeled_points(rng):
    seen = {}

    def fn(img, points, labels):
        seen["points"], seen["labels"], seen["shape"] = points, labels, img.shape
        return np.full(img.shape[:2], 1.0, np.float32)

    ed = PhotoEditor.from_rgb_f32(random_linear_image(rng, 24, 32), device="cpu", **KW)
    ed.set_crop(2, 2, 20, 20)  # the model still sees the full frame
    ed.add_model_mask("m", segmenter=fn, points_xy=[(3, 4), (10, 12)], labels=[1, 0])
    assert seen == {"points": [(3, 4), (10, 12)], "labels": [1, 0],
                    "shape": (24, 32, 3)}
    assert "m" in ed.mask_names()
