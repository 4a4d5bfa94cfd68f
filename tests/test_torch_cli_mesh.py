"""The port's multi-rank ``cli batch`` on four CPU ranks (torch.distributed,
gloo): the batch sharded over the ranks writes files byte for byte those
of its single-device loop (``--no-mesh --exact-path``) — the same four DNGs
as tests/test_cli_mesh.py, with a second shape, three images on four ranks
(one rank idle), and a RAW + JPEG pair of one stem (collision-safe names,
a non-RAW input). Also the routing: one process outside a world stays on
the single-device loop, ``--no-mesh`` in a world leaves the loop to rank 0,
and the spawned-ranks path (one rank a card on a host with several) run
here with two gloo ranks.

One world of four ranks runs every batch (tests/torch_dist.cli_case) once
for the module."""

import os

import numpy as np
import pytest
from PIL import Image

from rawphotoforge_tpu_torch.app import cli

from torch_dist import cli_case, start_world, warm_port_cpu

FLAGS = ["--exposure", "0.5", "--vignette", "30", "--sharpness", "25",
         "--saturation-curve", "0:40000,65535:36000"]
FOUR = [("a.dng", (48, 64)), ("b.dng", (48, 64)), ("c.dng", (48, 64)),
        ("d.dng", (40, 56))]


def _write_dngs(ind, shapes_names, seed=5):
    """tests/test_cli_mesh.py's DNGs, through the port's writers."""
    from rawphotoforge_tpu_torch.io.dng import write_dng
    from rawphotoforge_tpu_torch.io.raw import synthetic_raw

    ind.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, (h, w) in shapes_names:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        rgb = np.clip(np.stack([
            0.2 + 0.5 * xx / w + 0.05 * rng.random((h, w)),
            0.3 + 0.4 * yy / h,
            0.5 - 0.2 * xx / w,
        ]), 0, 1).astype(np.float32)
        (ind / name).write_bytes(
            write_dng(synthetic_raw(rgb, wb_gains=(1.8, 1.0, 1.4))))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    warm_port_cpu()
    root = tmp_path_factory.mktemp("cli_mesh")
    _write_dngs(root / "four", FOUR)
    _write_dngs(root / "three", [FOUR[0], FOUR[1], FOUR[3]])
    _write_dngs(root / "pair", [("IMG_0001.dng", (48, 64))])
    Image.new("RGB", (64, 48), (90, 120, 40)).save(root / "pair" / "IMG_0001.jpg")
    return root


RUNS = {"four": FLAGS, "three": FLAGS, "pair": ["--exposure", "0.3"],
        "nomesh": ["--no-mesh", "--exact-path", *FLAGS],
        "nocard": [*FLAGS, "--device", "cuda"]}


@pytest.fixture(scope="module")
def world(dirs, tmp_path_factory):
    runs = [(str(dirs / ("four" if k in ("nomesh", "nocard") else k)),
             str(dirs / f"out_{k}"), f) for k, f in RUNS.items()]
    ranks = start_world(cli_case, 4, tmp_path_factory.mktemp("cli_world"), runs=runs)
    # The single-device files, written while the ranks run.
    for name, flags in (("four", FLAGS), ("three", FLAGS), ("pair", RUNS["pair"])):
        _single(dirs, name, flags)
    res = ranks.results()
    return {k: [r[i] for r in res] for i, k in enumerate(RUNS)}


def _single(dirs, name, flags):
    out = dirs / f"single_{name}"
    if not out.exists():
        assert cli.main(["batch", str(dirs / name), str(out), "--no-mesh",
                         "--exact-path", *flags, "--device", "cpu"]) == 0
    return out


def _same_files(a, b, names):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), (
            f"{n}: mesh and single-device bytes differ")


@pytest.mark.parametrize("name,n_images", [("four", 4), ("three", 3)])
def test_batch_mesh_byte_identical_to_single_loop(world, dirs, name, n_images):
    """Four images on four ranks, and three (one rank without an image),
    with two shapes: the files equal the single-device loop's."""
    for rank, (rc, out) in enumerate(world[name]):
        assert rc == 0
        if rank:
            assert out == ""  # rank 0 prints for the batch
    out = world[name][0][1]
    assert f"batch (mesh x4): {n_images} images" in out, out
    lines = [ln for ln in out.splitlines() if " -> " in ln]
    srcs = sorted(str(dirs / name / n) for n in os.listdir(dirs / name))
    assert [ln.split(" -> ")[0].strip() for ln in lines] == srcs  # input order
    names = [n.replace(".dng", ".jpg") for n in sorted(os.listdir(dirs / name))]
    _same_files(dirs / f"out_{name}", _single(dirs, name, FLAGS), names)


def test_batch_mesh_handles_nonraw_and_naming(world, dirs):
    """A RAW and a JPEG of one stem: both on the mesh path, collision-safe
    names, each file its single-device twin."""
    rc, out = world["pair"][0]
    assert rc == 0 and "mesh x4" in out
    names = sorted(os.listdir(dirs / "out_pair"))
    assert len(names) == 2
    for n in names:
        assert (dirs / "out_pair" / n).read_bytes()[:2] == b"\xff\xd8"
    _same_files(dirs / "out_pair", _single(dirs, "pair", RUNS["pair"]), names)


def test_batch_no_mesh_in_a_world_runs_on_rank_zero(world, dirs):
    rcs = [rc for rc, _ in world["nomesh"]]
    assert rcs == [0, 0, 0, 0]
    assert "(mesh x" not in world["nomesh"][0][1]
    assert all(out == "" for _, out in world["nomesh"][1:])
    names = sorted(n.replace(".dng", ".jpg") for n in os.listdir(dirs / "four"))
    _same_files(dirs / "out_nomesh", _single(dirs, "four", FLAGS), names)


def test_batch_in_a_world_without_a_card_refuses_cuda(world, dirs):
    """``--device cuda`` in a world on a host without a card: every rank
    exits 2 (the device rule: no silent CPU fallback) and writes nothing."""
    assert [rc for rc, _ in world["nocard"]] == [2, 2, 2, 2]
    assert not os.listdir(dirs / "out_nocard")


def test_mesh_devices_gives_each_rank_its_card():
    """A CUDA ``--device`` without an index leaves the card to LOCAL_RANK
    (``make_mesh(devices=None)``); "cpu" stays; a named card stays under
    gloo (ranks may share it) and in a world of one, and is refused in an
    NCCL world of several ranks."""
    from rawphotoforge_tpu_torch.errors import PhotoEditorError

    for backend in ("gloo", "nccl"):
        assert cli._mesh_devices(None, 4, backend) is None
        assert cli._mesh_devices("cuda", 4, backend) is None
        assert cli._mesh_devices("cpu", 4, backend) == "cpu"
        assert cli._mesh_devices("cuda:0", 1, backend) == "cuda:0"
    assert cli._mesh_devices("cuda:0", 2, "gloo") == "cuda:0"
    with pytest.raises(PhotoEditorError, match="names one card"):
        cli._mesh_devices("cuda:1", 2, "nccl")
    assert cli._world_backend("cpu") == "gloo"
    assert cli._world_backend(None) == cli._world_backend("cuda") == "nccl"


def test_batch_outside_a_world_stays_single(dirs, tmp_path, capsys):
    """One process and no card: the single-device loop."""
    assert cli.main(["batch", str(dirs / "three"), str(tmp_path / "o"), *FLAGS,
                     "--exact-path", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(mesh x" not in out and "batch: 3 images" in out


def test_spawned_ranks_write_the_single_loop_files(dirs, tmp_path):
    """The path of a host with several cards (one spawned rank a card),
    with two gloo ranks on the CPU."""
    out = tmp_path / "spawned"
    args = cli._parser().parse_args(
        ["batch", str(dirs / "three"), str(out), *FLAGS, "--device", "cpu"])
    os.makedirs(out)
    paths = sorted(str(dirs / "three" / n) for n in os.listdir(dirs / "three"))
    assert cli._spawn_mesh_batch(paths, args, 2) == 0
    names = [n.replace(".dng", ".jpg") for n in sorted(os.listdir(dirs / "three"))]
    _same_files(out, _single(dirs, "three", FLAGS), names)
