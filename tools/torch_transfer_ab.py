"""Host-to-device upload A/B on the card: ways of staging an upload through
page-locked memory, against torch's own copy from pageable memory, at the
sizes the port's paths upload, and `cli batch`'s stages with each way.

    python3 tools/torch_transfer_ab.py           # both parts
    python3 tools/torch_transfer_ab.py --batch   # the batch's stages only

Run from the root of a checkout (the package and chip_smoke.py are imported
from the working directory), so the same file runs on a parent tree
unpacked elsewhere (copy it there with chip_smoke.py). Needs a CUDA card.

Part 1 (uploads): each way is timed by the host clock around a
synchronized call (the median of 7 after one warm call), for each size in
turns, forward and backward, three rounds; each way's tensor is checked bit
for bit against torch.from_numpy(a). The ways:

  to         torch.from_numpy(a).to(dev): the CUDA driver stages pageable memory
  put_np     the tree's utils/transfer.put_np
  one        one np.copyto into a page-locked tensor, one non-blocking copy
  pool8      a thread pool made per call, 8 MB bands, each band's copy
             issued when it is staged (the first put_np design)
  torch8     bands of 8 MB staged by torch's copy_ (intra-op threads), each
             band's non-blocking copy issued as soon as it is staged
  torch2     the same with 2 MB bands

Part 2 (`cli batch` of chip_smoke's two DNGs, warm, with chip_smoke's
StageClock): the stages in ms per image; without --batch once for each
way patched in as utils/transfer.put_np (the mosaic upload goes through
it), in turns. The last line is one JSON object of the medians.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.getcwd())

SIZES = (("u16 mosaic 24 MP", (4000, 6000), np.int16),
         ("u16 mosaic X-Trans 26 MP", (4160, 6240), np.int16),
         ("u16 mosaic 45.4 MP", (5504, 8256), np.int16),
         ("u8 planes 24 MP", (3, 4000, 6000), np.uint8),
         ("u16 planes 24 MP", (3, 4000, 6000), np.int16),
         ("f32 planes 24 MP", (3, 4000, 6000), np.float32))


def _side(dev):
    from rawphotoforge_tpu_torch.utils import transfer

    return transfer._side_stream(dev)


def _finish(out, done, dev):
    import torch

    current = torch.cuda.current_stream(dev)
    current.wait_event(done)
    out.record_stream(current)
    return out


def up_to(arr, dev):
    import torch

    return torch.from_numpy(arr).to(dev)


def up_one(arr, dev):
    import torch

    src = torch.from_numpy(arr)
    host = torch.empty(arr.shape, dtype=src.dtype, pin_memory=True)
    np.copyto(host.numpy(), arr)
    side = _side(dev)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        out = torch.empty(arr.shape, dtype=src.dtype, device=dev)
        out.copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return _finish(out, done, dev)


def up_pool8(arr, dev):
    """The first put_np: a pool made per call stages 8 MB bands (at most 8,
    from 16 MB up), each band's copy issued once it is staged."""
    import torch

    src = torch.from_numpy(arr)
    bands = 1 if arr.nbytes < (16 << 20) else min(8, arr.nbytes // (8 << 20))
    n = arr.size
    bounds = [n * i // bands for i in range(bands + 1)]
    spans = list(zip(bounds[:-1], bounds[1:]))
    host = torch.empty(arr.shape, dtype=src.dtype, pin_memory=True)
    flat, staged = arr.reshape(-1), host.numpy().reshape(-1)
    side = _side(dev)
    with ThreadPoolExecutor(max(1, min(len(spans), 16))) as pool, \
            torch.cuda.device(dev), torch.cuda.stream(side):
        futs = [pool.submit(np.copyto, staged[a:b], flat[a:b]) for a, b in spans]
        out = torch.empty(arr.shape, dtype=src.dtype, device=dev)
        h, d = host.reshape(-1), out.reshape(-1)
        for (a, b), f in zip(spans, futs):
            f.result()
            d[a:b].copy_(h[a:b], non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return _finish(out, done, dev)


def _up_torch(arr, dev, band_bytes):
    import torch

    src = torch.from_numpy(arr)
    host = torch.empty(arr.shape, dtype=src.dtype, pin_memory=True)
    n = arr.size
    step = max(1, band_bytes // arr.itemsize)
    side = _side(dev)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        out = torch.empty(arr.shape, dtype=src.dtype, device=dev)
        s, h, d = src.reshape(-1), host.reshape(-1), out.reshape(-1)
        for a in range(0, n, step):
            b = min(a + step, n)
            h[a:b].copy_(s[a:b])
            d[a:b].copy_(h[a:b], non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return _finish(out, done, dev)


def up_torch8(arr, dev):
    return _up_torch(arr, dev, 8 << 20)


def up_torch2(arr, dev):
    return _up_torch(arr, dev, 2 << 20)


def ways():
    from rawphotoforge_tpu_torch.utils import transfer

    real = transfer.put_np
    return {"to": up_to, "put_np": lambda a, dev: real(a, device=dev),
            "one": up_one, "pool8": up_pool8, "torch8": up_torch8,
            "torch2": up_torch2}


def host_ms(fn, reps=7):
    import torch

    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def uploads(dev, card, rounds=3):
    import torch

    rng = np.random.default_rng(20261017)
    table = {}
    for name, shape, dtype in SIZES:
        if dtype == np.float32:
            arr = rng.random(shape, dtype=np.float32)
        else:
            info = np.iinfo(dtype)
            arr = rng.integers(info.min, info.max, shape, dtype=dtype)
        want = torch.from_numpy(arr)
        fns = ways()
        for way, fn in fns.items():
            got = fn(arr, dev).cpu()
            if not torch.equal(got, want):
                raise SystemExit(f"{way} changed the {name}")
        times = {w: [] for w in fns}
        order = list(fns)
        for r in range(rounds):
            for way in (order if r % 2 == 0 else order[::-1]):
                times[way].append(host_ms(lambda: fns[way](arr, dev)))
        table[name] = {w: float(np.median(ts)) for w, ts in times.items()}
        print(f"upload {name} {arr.nbytes / 1e6:.1f} MB, host ms (median of "
              f"{rounds} rounds of median-of-7): "
              + ", ".join(f"{w} {ms:.3f}" for w, ms in table[name].items())
              + f" [{card}]", flush=True)
        del arr, want
    return table


def batch_stages(dev, card, patch_ways, rounds=3):
    """`cli batch` of the two DNGs, warm, stages per image; with each of
    ``patch_ways`` as utils/transfer.put_np (None: the tree's own code)."""
    import shutil

    import chip_smoke as cs
    import torch

    from rawphotoforge_tpu_torch.utils import transfer

    tmp = tempfile.mkdtemp(prefix="transfer_ab_")
    in_dir = os.path.join(tmp, "in")
    os.makedirs(in_dir)
    cs.write_raw_dir(in_dir, lambda m: print(m, flush=True))
    n = len(os.listdir(in_dir))
    rc, _ = cs.run_batch(in_dir, os.path.join(tmp, "warm"), dev)
    if rc != 0:
        raise SystemExit(f"cli batch exited {rc}")
    real = getattr(transfer, "put_np", None)
    fns = ways() if patch_ways else {}
    keys = patch_ways or [None]
    rows = {k: [] for k in keys}
    try:
        for r in range(rounds):
            for way in (keys if r % 2 == 0 else keys[::-1]):
                if way is not None:
                    fn = fns[way]
                    transfer.put_np = (lambda a, bands=None, threads=None, device=None,
                                       _fn=fn: _fn(np.ascontiguousarray(a),
                                                   torch.device(device)))
                wall, clock = cs.staged_batch(in_dir, os.path.join(tmp, f"o{r}{way}"), dev)
                if real is not None:
                    transfer.put_np = real
                stages = {k: v / n for k, v in clock.ms.items()}
                stages["wall"] = wall / n
                rows[way].append(stages)
                print(f"batch ({way or 'tree'}), round {r}, ms/image: "
                      + clock.line(n) + f"; wall {wall / n:.2f} [{card}]", flush=True)
    finally:
        if real is not None:
            transfer.put_np = real
        shutil.rmtree(tmp, ignore_errors=True)
    return {str(k): {s: float(np.median([row[s] for row in v])) for s in v[0]}
            for k, v in rows.items()}


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_transfer_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, intra-op threads {torch.get_num_threads()}, "
          f"cpu cores {os.cpu_count()}", flush=True)
    from rawphotoforge_tpu_torch import native
    from rawphotoforge_tpu_torch.kernels import jpeg_wire, raw_pipeline

    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(m.library) for m in (native, jpeg_wire, raw_pipeline)]:
            f.result()
    out = {"card": card}
    if "--batch" in sys.argv:
        out["batch"] = batch_stages(dev, card, None)
    else:
        out["uploads"] = uploads(dev, card)
        out["batch"] = batch_stages(dev, card, ["to", "put_np", "one", "torch8", "torch2"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
