"""The port's utils/profiling on the CPU (the JAX package's
``utils/profiling.py``): fetch_sync over nested results, device_time's
contract (a positive median, the chained difference quotient, a raise on a
window that is not positive), and ``cli develop`` waiting with fetch_sync.
The spans and the work counters: ``test_torch_spans.py``."""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu_torch.utils import profiling


def test_fetch_sync_returns_its_argument():
    x = {"a": torch.ones(2), "b": [torch.zeros(3), (torch.arange(4), 5)], "c": None}
    assert profiling.fetch_sync(x) is x
    t = torch.ones(1)
    assert profiling.fetch_sync(t) is t


def test_device_time_without_chain_is_a_positive_median():
    x = torch.rand(256, 256)
    s = profiling.device_time(lambda a: a @ a, x, iters=5)
    assert isinstance(s, float) and 0.0 < s < 10.0


def test_device_time_chains_calls():
    calls = []

    def fn(a):
        calls.append(1)
        return a * 1.0001

    def chain(i, out, args):
        return (out,)

    s = profiling.device_time(fn, torch.rand(64, 64), iters=4, chain=chain,
                              min_window=0.0005, max_iters=256)
    assert s > 0.0 and len(calls) > 4 * 2


def test_device_time_raises_on_a_window_that_is_not_positive(monkeypatch):
    monkeypatch.setattr(profiling._Clock, "run", lambda self, work: 0.01)
    with pytest.raises(RuntimeError, match="non-positive window"):
        profiling.device_time(lambda a: a + 1, torch.ones(3),
                              chain=lambda i, out, args: (out,), max_iters=8)


def test_cli_develop_waits_with_fetch_sync(tmp_path, monkeypatch):
    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.io import image_io

    synced = []
    monkeypatch.setattr(cli, "fetch_sync", lambda x: synced.append(x) or x)
    src = tmp_path / "in.ppm"
    rgb = (np.random.default_rng(3).random((24, 32, 3)) * 65535).astype(np.uint16)
    src.write_bytes(image_io.encode_ppm16(rgb))
    assert cli.main(["develop", str(src), str(tmp_path / "out.png"),
                     "--exposure", "0.3", "--device", "cpu"]) == 0
    assert len(synced) == 1 and tuple(synced[0].shape) == (3, 24, 32)

