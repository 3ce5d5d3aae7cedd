"""The port end to end on the CPU: its CLI with --mode=cpu on
tests/test_pipeline.py's 160x160 SEM pair to a PLY mesh, against the JAX
package's reconstruct on the same files.

Tolerances: both runs draw the same RANSAC samples (the port's threefry,
utils.prng, equals jax.random's), so they pick the same F up to f32
rounding, and the meshes are held to the same vertex and face counts,
the same grid cells, and a mean |z| difference under 1e-6 of the JAX
depth range (on this pair they are equal). COUNT_RTOL and DEPTH_BUDGET —
vertex counts within 2 %, mean |z| under 1 % of the range, the budgets of
tests/test_golden_parity.py — hold runs whose samples differ, such as a
mesh's sharded RANSAC (tests/test_torch_parallel.py).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cybervision_tpu.config import MeshMode as JMeshMode
from cybervision_tpu.reconstruction import reconstruct as jax_reconstruct
from cybervision_tpu_torch import cli
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch.images import SourceImage
from cybervision_tpu_torch.reconstruction import Reconstruction

from .test_pipeline import _fast_cfg, _sem_pair

torch.set_num_threads(2)

COUNT_RTOL = 0.02
DEPTH_BUDGET = 0.01
SAME_F_DEPTH_BUDGET = 1e-6


def _port_fast_cfg(**kw):
    """tests/test_pipeline.py's _fast_cfg in the port's config."""
    return tcfg.ReconstructionConfig(
        ransac=tcfg.RansacConfig(
            ransac_k_affine=32768,
            check_interval=8192,
            ransac_d_early_exit_affine=200,
        ),
        correlation=tcfg.CorrelationConfig(scale_min_size=64),
        **kw,
    )


@pytest.fixture(scope="module")
def sem_files(tmp_path_factory):
    img1, img2, disparity = _sem_pair(np.random.RandomState(7))
    d = tmp_path_factory.mktemp("torch_sem")
    p1, p2 = str(d / "a.png"), str(d / "b.png")
    Image.fromarray(img1).save(p1)
    Image.fromarray(img2).save(p2)
    return p1, p2, disparity


def _read_ply(path):
    """(vertex count, {(x, y): z}) of a binary big-endian PLY of
    (x, y, z) doubles + rgb bytes, and the raw face count."""
    data = open(path, "rb").read()
    head, _, body = data.partition(b"end_header\n")
    text = head.decode()
    assert "binary_big_endian" in text
    nv = int(text.split("element vertex ")[1].split("\n")[0])
    nf = int(text.split("element face ")[1].split("\n")[0])
    rec = np.frombuffer(body[: nv * 27], dtype=[("xyz", ">f8", 3), ("rgb", "u1", 3)])
    xyz = rec["xyz"]
    cells = {(int(round(x)), int(round(-y))): z for x, y, z in xyz}
    return nv, nf, cells


def test_cli_cpu_ply_matches_jax(sem_files, tmp_path, monkeypatch):
    p1, p2, _ = sem_files
    out_j = str(tmp_path / "jax.ply")
    out_t = str(tmp_path / "port.ply")
    jax_reconstruct([p1, p2], out_j, _fast_cfg(mesh=JMeshMode.VERTEX_COLORS), quiet=True)
    # The CLI has no flag for the RANSAC budget or the pyramid floor:
    # give its config the same reduced budget as the JAX run.
    monkeypatch.setattr(cli, "ReconstructionConfig", _port_fast_cfg)
    rc = cli.main(["--mode=cpu", "--projection=parallel", "--mesh=vertex-colors", p1, p2, out_t])
    assert rc == 0
    nv_j, nf_j, cells_j = _read_ply(out_j)
    nv_t, nf_t, cells_t = _read_ply(out_t)
    assert nv_j > 3000 and nf_t > 3000
    assert (nv_t, nf_t) == (nv_j, nf_j)
    assert cells_t.keys() == cells_j.keys()
    zj = np.array([cells_j[k] for k in cells_j])
    zt = np.array([cells_t[k] for k in cells_j])
    assert np.abs(zt - zj).mean() / (zj.max() - zj.min()) < SAME_F_DEPTH_BUDGET


def test_in_memory_images_equal_file_loads(sem_files):
    p1, _, _ = sem_files
    loaded = SourceImage.load(p1)
    arr = np.asarray(Image.open(p1).convert("L"))
    mem = SourceImage(arr.copy())
    np.testing.assert_array_equal(mem.img, loaded.img)
    assert mem.dimensions == loaded.dimensions == (160, 160)
    # PIL's convert("RGB") of an "L" image repeats the gray plane.
    np.testing.assert_array_equal(mem.load_rgb_plane(), loaded.load_rgb_plane())


@pytest.mark.parametrize(
    "out,kw,lane",
    [
        ("depth.png", {"interpolation": tcfg.InterpolationMode.NONE}, "PNG fast lane"),
        ("mesh.ply", {"max_points": 1000}, "word and generic lanes"),
        ("mesh.obj", {}, "word and generic lanes"),
        ("mesh.ply", {"projection": tcfg.ProjectionMode.PERSPECTIVE}, "perspective"),
    ],
)
def test_unported_lanes_raise(sem_files, tmp_path, out, kw, lane):
    """Every lane but the fused PLY one names its ROADMAP.md item."""
    p1, p2, _ = sem_files
    base = {"projection": tcfg.ProjectionMode.AFFINE, "hardware": tcfg.HardwareMode.CPU}
    cfg = tcfg.ReconstructionConfig(**{**base, **kw})
    rec = Reconstruction([p1, p2], str(tmp_path / out), cfg, quiet=True)
    with pytest.raises(NotImplementedError, match=lane) as err:
        rec.run()
    assert "ROADMAP.md" in str(err.value)


def test_native_ply_writers_match_jax_package(tmp_path):
    """The port's copy of the native writer, from the word plane and from
    the delta plane, writes the JAX package's bytes."""
    from cybervision_tpu import native as jnative
    from cybervision_tpu_torch import native as tnative
    from cybervision_tpu_torch.interop import correlation_state_from_numpy
    from cybervision_tpu_torch.ops.correlation import pack_state_delta

    rng = np.random.RandomState(8)
    h, w = 21, 26
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack([xs - rng.randint(0, 9, (h, w)), ys + rng.randint(-1, 2, (h, w))], -1)
    valid = rng.uniform(size=(h, w)) < 0.8
    d16, word = pack_state_delta(
        correlation_state_from_numpy(np.clip(pos, 0, None), np.ones((h, w)), valid)
    )
    d16 = d16.numpy().astype(np.uint16)
    word = word.numpy()
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    scale = (1.0, 1.0, -1.0)
    paths = [str(tmp_path / f"{n}.ply") for n in ("jax", "word", "delta")]
    jnative.ply_write_corr_grid(paths[0], word, scale, rgb)
    tnative.ply_write_corr_grid(paths[1], word, scale, rgb)
    tnative.ply_write_delta_grid(paths[2], d16, scale, rgb)
    ref = open(paths[0], "rb").read()
    assert len(ref) > 1000
    assert open(paths[1], "rb").read() == ref
    assert open(paths[2], "rb").read() == ref
