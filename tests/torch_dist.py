"""Spawned torch.distributed worlds for the port's multi-rank tests, free of
jax: a spawned rank imports this module (and the port), never a test
module (those import jax) and never tests/conftest.py.

``start_world(case, world, tmp_dir, **kwargs)`` starts ``world`` ranks
under ``gloo`` (the CPU backend) that meet through a file store in
``tmp_dir`` and run ``case(**kwargs)`` each; the test process goes on (it
computes its references meanwhile) until ``World.results()`` collects the
per-rank results (numpy arrays and plain values). ``run_world`` is the two
at once. A rank that raises fails the call with its traceback; a world that
does not finish by the deadline is killed and fails it too, so a hang costs
the deadline, not the suite's clock.

A rank runs its case on one intra-op thread, as torchrun gives its
workers, after one develop call: ``warm_port_cpu``, or with
``first_calls=True`` the first calls that ``first_develop_calls`` measures
on two threads (``World.first_calls``).

The cases (``mesh_case``, ``spatial_case``, ``cli_case``, ``loaded_modules``)
hold the port's side of tests/test_torch_mesh.py, test_torch_spatial.py,
test_torch_cli_mesh.py and test_torch_imports.py.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import pickle
import sys
import traceback

import numpy as np

# Each rank waits this long for its peers (rendezvous and collectives).
RANK_TIMEOUT = datetime.timedelta(seconds=60)


class World:
    """Spawned ranks running a case; ``results()`` waits for them."""

    def __init__(self, procs, tmp_dir: str, deadline: float):
        import time

        self._procs, self._tmp_dir = procs, tmp_dir
        self._end = time.monotonic() + deadline
        self._deadline = deadline
        self._results = None
        self.first_calls = None

    def results(self) -> list:
        """The ranks' results in rank order (collected once)."""
        import time

        if self._results is not None:
            return self._results
        procs, world = self._procs, len(self._procs)
        for p in procs:
            p.join(max(0.0, self._end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise AssertionError(f"ranks {hung} of {world} still running after "
                                 f"{self._deadline:.0f} s: killed")
        results, firsts = [], []
        for r, p in enumerate(procs):
            path = os.path.join(self._tmp_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise AssertionError(f"rank {r} exited with {p.exitcode} and no result")
            with open(path, "rb") as f:
                status, value, first = pickle.load(f)
            if status != "ok":
                raise AssertionError(f"rank {r} failed:\n{value}")
            results.append(value)
            firsts.append(first)
        self._results, self.first_calls = results, firsts
        return results


def start_world(case, world: int, tmp_dir, deadline: float = 240.0,
                first_calls: bool = False, **kwargs) -> World:
    """Start ``case(**kwargs)`` on ``world`` gloo ranks; returns at once."""
    import multiprocessing

    tmp_dir = str(tmp_dir)
    ctx = multiprocessing.get_context("spawn")
    init = os.path.join(tmp_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(case.__name__, r, world, init, tmp_dir, first_calls,
                               kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    return World(procs, tmp_dir, deadline)


def run_world(case, world: int, tmp_dir, deadline: float = 240.0, **kwargs):
    """Run ``case(**kwargs)`` on ``world`` gloo ranks; returns their results
    in rank order."""
    return start_world(case, world, tmp_dir, deadline, **kwargs).results()


def _rank_main(case_name, rank, world, init, tmp_dir, first_calls, kwargs):
    import torch
    import torch.distributed as dist

    out = os.path.join(tmp_dir, f"rank{rank}.pkl")
    os.environ["LOCAL_RANK"] = str(rank)  # as torchrun sets it
    first = None
    try:
        if first_calls:
            first = first_develop_calls()  # also the rank's warm-up
            torch.set_num_threads(1)
        else:
            torch.set_num_threads(1)
            warm_port_cpu()
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=RANK_TIMEOUT)
        try:
            result = ("ok", globals()[case_name](**kwargs), first)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc(), first), f)
        raise
    with open(out, "wb") as f:
        pickle.dump(result, f)


FIRST_CALL_FRAMES = ((32, 128), (128, 384))
FIRST_CALL_THREADS = 2


def first_develop_calls() -> dict:
    """A fresh process's first develop calls, each made three times on
    FIRST_CALL_THREADS intra-op threads: {frame: (max |first - second|,
    max |second - third|, the rows where first and second differ)}. The
    input and edit are ROADMAP C's (seeded linear frames, tone, WB and
    vignette); the larger frame is split over the threads. (At the default
    thread count, one a core, four ranks at once take ~20 s instead of ~3 s
    here.) The calls also warm the rank up: its compared calls come after."""
    import torch

    from rawphotoforge_tpu_torch.ops import develop

    torch.set_num_threads(FIRST_CALL_THREADS)
    rng = np.random.default_rng(1234)
    params = _pack([("set_tone", (0.8, 25, 10)), ("set_whitebalance", (20, -10)),
                    ("set_vignette", (35,))])
    out = {}
    for h, w in FIRST_CALL_FRAMES:
        img = rng.random((h, w, 3), dtype=np.float32) ** 2.0
        img[:4, :4] = 0.0
        img[-4:, -4:] = 1.0
        x = torch.from_numpy(img.transpose(2, 0, 1).copy())
        a, b, c = (develop.develop(x, params, None) for _ in range(3))
        rows = torch.nonzero((a != b).any(0).any(-1)).reshape(-1).tolist()
        out[(h, w)] = (float((a - b).abs().max()), float((b - c).abs().max()), rows)
    return out


def warm_port_cpu():
    """One small develop on the CPU before a process's compared calls. The
    first develop call of a process could be off (ROADMAP C, repaired in
    ops/pointwise); this warm-up keeps a return of that fault to one test,
    test_torch_mesh.py::test_first_develop_call_of_a_fresh_process, whose
    ranks measure their first calls (first_develop_calls)."""
    import torch

    from rawphotoforge_tpu_torch.ops import develop

    develop.develop(torch.rand(3, 32, 128), _pack([("set_vignette", (35,))]), None)


def _np(t):
    return t.detach().cpu().numpy()


def apply_edit(p, spec):
    """Apply an edit spec — (method, args) pairs — to an EditParameters of
    either package (both have the same setters)."""
    for name, args in spec:
        getattr(p, name)(*args)
    return p


def loaded_modules():
    """The jax and JAX-package modules this rank has loaded."""
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "rawphotoforge_tpu"))


# -- tests/test_torch_mesh.py -------------------------------------------------------

MESH_SHAPES = ((2, 2), (1, 4), (4, 1))


def _pack(spec, extent=None):
    from rawphotoforge_tpu_torch.core.params import EditParameters, pack_params

    return pack_params([apply_edit(EditParameters(), spec)], extent=extent,
                       device="cpu")


def mesh_case(imgs, planes, uneven, kernel, srgb, mosaics, geos, quality):
    """Every function of parallel/mesh on each of MESH_SHAPES. Inputs are
    numpy; ``planes`` / ``uneven`` / ``kernel`` are dicts of a case's
    arrays and edit specs. Returns {shape: {name: gathered numpy}}."""
    import torch

    from rawphotoforge_tpu_torch.io import jpegenc
    from rawphotoforge_tpu_torch.parallel import mesh as pm

    qlum, qchr = jpegenc._quant_tables(quality)
    t = torch.from_numpy
    out = {}
    for nb, ns in MESH_SHAPES:
        m = pm.make_mesh(nb, ns, devices="cpu")
        r = out[(nb, ns)] = {"shape": dict(m.shape),
                             "coords": (m.batch_index, m.sp_index)}
        params = _pack(planes["edit"])
        ones = torch.ones((1,) + planes["img"].shape[1:])

        blk = pm.shard_batch(t(imgs), m)
        r["batch_develop"] = _np(pm.gather_batch(
            pm.batch_develop_sharded(blk, params, torch.ones(1, *imgs.shape[2:]), m), m))
        r["export_u8"] = _np(pm.gather_batch(
            pm.export_batch_step(blk, params, torch.ones(1, *imgs.shape[2:]), m), m))

        img = t(planes["img"])
        r["spatial"] = _np(pm.gather_rows(pm.develop_spatial_sharded(
            pm.shard_rows(img, m), params, pm.shard_rows(ones, m), m), m))
        r["hist"] = _np(pm.histogram_sharded(pm.shard_rows(img, m), m))
        warp = _pack(planes["warp_edit"])
        srgb_w, hist_w, clip_w = pm.full_step(pm.shard_rows(img, m), warp,
                                              pm.shard_rows(ones, m), m)
        r["full_step_warp"] = (_np(pm.gather_rows(srgb_w, m)), _np(hist_w),
                               float(clip_w))

        for key, arr in uneven.items():
            x = t(arr)
            h = x.shape[1]
            o = torch.ones((1, h, x.shape[2]))
            s_, h_, c_ = pm.full_step(pm.shard_rows(x, m), params,
                                      pm.shard_rows(o, m), m, h=h)
            r[f"full_step_{key}"] = (_np(pm.gather_rows(s_, m)), _np(h_), float(c_))
            r[f"hist_{key}"] = _np(pm.histogram_sharded(pm.shard_rows(x, m), m))

        for key, case in kernel.items():
            x, mk = t(case["img"]), t(case["masks"])
            h, w = x.shape[1:]
            kp = _pack(case["edit"], extent=(h, w))
            r[f"kernel_{key}"] = _np(pm.gather_rows(pm.develop_spatial_sharded(
                pm.shard_rows(x, m), kp, pm.shard_rows(mk, m), m,
                use_kernel=True, h=h), m))

        sb = pm.shard_batch(t(srgb), m)
        r["entropy"] = tuple(_np(pm.gather_batch(a, m)) for a in
                             pm.entropy_batch_sharded(sb, m, qlum, qchr))
        r["entropy_packed"] = tuple(_np(pm.gather_batch(a, m)) for a in
                                    pm.entropy_batch_packed_sharded(sb, m, qlum, qchr))
        r["jpeg_packed_step"] = tuple(_np(pm.gather_batch(a, m)) for a in
                                      pm.export_batch_jpeg_packed_step(
                                          blk, params, None, m, qlum, qchr))
        r["jpeg_step"] = tuple(_np(pm.gather_batch(a, m)) for a in
                               pm.export_batch_jpeg_step(blk, params, None, m,
                                                         qlum, qchr))

        for pattern, mos in mosaics["frames"].items():
            mb = pm.shard_batch(t(mos[:nb]), m)
            rp = _pack(mosaics["edit"])
            words, totals = pm.export_batch_raw_fused_packed_step(
                mb, mosaics["wb"], mosaics["cam"], rp, mosaics["sharpen"], m,
                qlum, qchr, pattern=pattern)
            r[f"raw_{pattern}"] = (_np(pm.gather_batch(words, m)),
                                   _np(pm.gather_batch(totals, m)))
        try:
            pm.export_batch_raw_fused_packed_step(
                t(mosaics["frames"]["RGGB"][:2]), mosaics["wb"], mosaics["cam"],
                _pack(mosaics["edit"]), mosaics["sharpen"], m, qlum, qchr)
            r["raw_two_images"] = None
        except ValueError as e:
            r["raw_two_images"] = str(e)

        gp = _pack(geos["edit"], extent=geos["true"])
        r["editor_packed"] = tuple(_np(pm.gather_batch(a, m)) for a in
                                   pm.export_batch_editor_packed_step(
                                       pm.shard_batch(t(geos["planes"]), m), gp, m,
                                       qlum, qchr, geos["true"]))
    # A mesh smaller than the world (ranks 2 and 3 outside it), with one
    # device a rank given as a list.
    m = pm.make_mesh(1, 2, devices=["cpu"] * 4)
    try:
        img = t(planes["img"])
        out["part"] = (m.device.type, _np(pm.histogram_sharded(pm.shard_rows(img, m), m)))
    except ValueError as e:
        out["part"] = (m.device.type, str(e))
    errors = []
    for shape in ((64, 2), (1, 16)):
        try:
            pm.make_mesh(*shape) if shape[0] != 1 else pm.make_mesh(n_spatial=16)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["too_many"] = errors
    # devices "cuda" (no index): each rank takes the card LOCAL_RANK names.
    # Only the mapping is checked: the card's presence is faked.
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        out["cuda_device"] = str(pm.make_mesh(devices="cuda").device)
    finally:
        torch.cuda.is_available = real
    return out


# -- tests/test_torch_spatial.py ------------------------------------------------------

def spatial_case(exchange, demosaic, bilinear, warp, uneven, extent, raw,
                 rejects, odd):
    """Every function of parallel/spatial on its meshes. Returns {name:
    gathered numpy}."""
    import torch

    from rawphotoforge_tpu_torch.parallel import mesh as pm, spatial as sp

    t = torch.from_numpy
    m22 = pm.make_mesh(2, 2, devices="cpu")
    m14 = pm.make_mesh(1, 4, devices="cpu")
    m41 = pm.make_mesh(4, 1, devices="cpu")
    r = {}
    x = t(exchange)
    r["exchange"] = _np(sp._exchange_rows(pm.shard_rows(x, m14), m14))
    for key, mesh in (("22", m22), ("14", m14)):
        r[f"demosaic_{key}"] = _np(pm.gather_rows(sp.demosaic_sharded(
            pm.shard_rows(t(demosaic), mesh), mesh, "RGGB", "malvar"), mesh))
    r["bilinear"] = _np(pm.gather_rows(sp.demosaic_sharded(
        pm.shard_rows(t(bilinear), m22), m22, "GRBG", "bilinear"), m22))
    for key, mesh in (("22", m22), ("14", m14)):
        img = t(warp["img"][key])
        for d in warp["strengths"][key]:
            blk = pm.shard_rows(img, mesh)
            got = sp.distortion_sharded(blk, float(d), mesh)
            if d == 0:
                r[f"warp_{key}_0_identity"] = got is blk
            r[f"warp_{key}_{d}"] = _np(pm.gather_rows(got, mesh))
    img = t(uneven["img"])
    r["warp_uneven"] = _np(pm.gather_rows(sp.distortion_sharded(
        pm.shard_rows(img, m22), uneven["d"], m22, h=img.shape[1]), m22))
    r["warp_uneven_14"] = _np(pm.gather_rows(sp.distortion_sharded(
        pm.shard_rows(img, m14), uneven["d"], m14, h=img.shape[1]), m14))
    img = t(extent["img"])
    r["warp_extent"] = _np(pm.gather_rows(sp.distortion_sharded(
        pm.shard_rows(img, m22), extent["d"], m22, extent=extent["true"]), m22))
    mos = t(raw["mosaic"])
    for key, amt in (("sharp", raw["sharpen"]), ("plain", None)):
        r[f"raw_{key}"] = _np(pm.gather_rows(sp.raw_develop_sharded(
            pm.shard_rows(mos, m22), raw["wb"], raw["cam"], m22, "RGGB", amt), m22))
    errs = {}
    for key, arr in rejects.items():
        try:
            sp.demosaic_sharded(pm.shard_rows(t(arr), m22), m22, h=arr.shape[0])
            errs[key] = None
        except ValueError as e:
            errs[key] = str(e)
    r["rejects"] = errs
    r["odd_single_shard"] = _np(pm.gather_rows(sp.demosaic_sharded(
        pm.shard_rows(t(odd), m41), m41, "RGGB"), m41))
    return r


# -- tests/test_torch_cli_mesh.py ------------------------------------------------------

def cli_case(runs):
    """``cli batch`` in this world for each (in_dir, out_dir, flags) of
    ``runs``; returns each run's (return code, rank's stdout)."""
    from rawphotoforge_tpu_torch.app import cli

    results = []
    for in_dir, out_dir, flags in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dev = [] if "--device" in flags else ["--device", "cpu"]
            rc = cli.main(["batch", in_dir, out_dir, *flags, *dev])
        results.append((rc, buf.getvalue()))
    return results

