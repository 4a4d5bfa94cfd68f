"""Shared helpers of the server parity tests (tests/test_torch_server*.py):
the JAX package's server and the port's behind one request sequence."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Decoded-JPEG bound between the two packages' previews (u8 levels), the
# bound of tests/test_torch_batch.py: at most 3 levels apart, at most
# 1.5 % of samples more than 1 apart.
JPEG_MAX, JPEG_FRAC_OVER_1 = 3, 0.015


def start(httpd) -> str:
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def request(base, path, body=None, raw=None, method=None, headers=None):
    """(status, headers, body bytes) of one request; an HTTP error status
    is returned, not raised. ``body`` is sent as JSON, ``raw`` as is."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data,
                                 method=method or ("GET" if data is None else "POST"),
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def decode(jpeg: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), dtype=np.int16)


def assert_images_close(a: bytes, b: bytes, what=""):
    x, y = decode(a), decode(b)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    d = np.abs(x - y)
    assert d.max() <= JPEG_MAX, (what, int(d.max()))
    assert (d > 1).mean() <= JPEG_FRAC_OVER_1, (what, float((d > 1).mean()))


def assert_hist_close(a, b, what=""):
    """Two [4, 256] histograms of renders within the JPEG bound: the same
    pixel count per row, and cumulative counts that never drift apart by
    more than a few percent (a pixel one u8 level off moves one count one
    bin)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape == (4, 256), what
    assert (a.sum(axis=1) == b.sum(axis=1)).all(), what
    drift = np.abs(np.cumsum(a, axis=1) - np.cumsum(b, axis=1)).max()
    assert drift <= 0.05 * a[0].sum(), (what, int(drift))


def _hwc(planes, true_shape=None, host_crop=None) -> np.ndarray:
    a = planes.detach().cpu().numpy() if hasattr(planes, "detach") else np.asarray(planes)
    a = a.transpose(1, 2, 0)
    if true_shape is not None:
        a = a[:true_shape[0], :true_shape[1]]
    if host_crop is not None:
        r0, r1, c0, c1 = host_crop
        a = a[r0:r1, c0:c1]
    return a


def capture_renders(monkeypatch):
    """Record the render each package's server encodes (the planes given to
    image_io.encode_image / jpegenc.encode_jpeg, cropped as the encoder
    crops them): ``renders["jax"|"port"]``, the last one of each."""
    import rawphotoforge_tpu.io.image_io as jio
    import rawphotoforge_tpu.io.jpegenc as jjpeg
    import rawphotoforge_tpu_torch.io.image_io as tio
    import rawphotoforge_tpu_torch.io.jpegenc as tjpeg

    renders = {}
    for key, io_mod, jpeg_mod in (("jax", jio, jjpeg), ("port", tio, tjpeg)):
        def enc_image(planes, fmt, *a, _real=io_mod.encode_image, _key=key, **k):
            renders[_key] = _hwc(planes, host_crop=k.get("host_crop"))
            return _real(planes, fmt, *a, **k)

        def enc_jpeg(planes, *a, _real=jpeg_mod.encode_jpeg, _key=key, **k):
            renders[_key] = _hwc(planes, true_shape=k.get("true_shape"))
            return _real(planes, *a, **k)

        monkeypatch.setattr(io_mod, "encode_image", enc_image)
        monkeypatch.setattr(jpeg_mod, "encode_jpeg", enc_jpeg)
    return renders


class Pair:
    """The JAX server and the port's server, each request sent to both.
    With ``renders`` (``capture_renders``), a device-rendered image whose
    JPEGs miss the decoded bound (q90 JPEG turns a one-level u8 flip on a
    noisy image into several levels) is judged on the renders before the
    JPEG, with ``torch_parity.assert_close_across``."""

    def __init__(self, jbase, tbase, renders=None):
        self.jbase, self.tbase = jbase, tbase
        self.renders = renders

    def both(self, path, body=None, raw=None, method=None, headers=None):
        j = request(self.jbase, path, body, raw, method, headers)
        t = request(self.tbase, path, body, raw, method, headers)
        assert j[0] == t[0], (path, j[0], t[0], j[2][:300], t[2][:300])
        return j, t

    def same_json(self, path, body=None, raw=None, method=None):
        j, t = self.both(path, body, raw, method)
        assert json.loads(j[2]) == json.loads(t[2]), (path, j[2][:300], t[2][:300])
        return json.loads(t[2]), t[0]

    def same_image(self, path, headers=("X-RPF-HostDrag", "X-RPF-Instant")):
        if self.renders is not None:
            self.renders.clear()
        j, t = self.both(path)
        assert j[0] == 200, (path, j[0], j[2][:300])
        for k in headers:
            assert (k in j[1]) == (k in t[1]), (path, k)
        try:
            assert_images_close(j[2], t[2], path)
        except AssertionError:
            if not self.renders or set(self.renders) != {"jax", "port"}:
                raise
            from torch_parity import assert_close_across

            assert_close_across(self.renders["port"], self.renders["jax"])
        return j, t

    def wait_ready(self, timeout=120):
        deadline = time.monotonic() + timeout
        for base in (self.jbase, self.tbase):
            while True:
                st = json.loads(request(base, "/open/status")[2])
                if st["ready"]:
                    break
                assert time.monotonic() < deadline, "open never became ready"
                time.sleep(0.05)
