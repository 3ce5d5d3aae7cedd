"""The port's multi-device path on CPU meshes, against its own unsharded
path and the JAX package's sharded functions.

A CPU mesh is several shards on the CPU device (parallel.Mesh allows a
repeated device): the halo exchange, the global row bounds and the
per-shard calls run for real, with each kernel's plain version. The JAX
side runs on 4 (or 2, 3, 8) of the conftest's 8 virtual devices, its
sweep kernel in interpret mode.

Tolerances: the sharded port equals the unsharded port exactly (the
row-halo sweep sees every value and rounding of the unsharded one);
against JAX's sharded sweep, tests/test_pallas_ncc.py:52-60's (under
0.5 % of valid flags differ, corr within 1e-4, over 99.5 % of positions
equal); the sharded matcher equals JAX's exactly; from the same key,
each shard draws what its JAX device draws (split(key, n), threefry), so
RANSAC picks JAX's winner (count equal, F within 1e-5 of its largest
entry), for one batch and for the whole round loop; the reconstruction
under a mesh stays within tests/test_torch_pipeline.py's 2 % / 1 %
budgets of the unsharded run (a mesh splits the round key, so its
samples are not the unsharded run's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from scipy import ndimage

from cybervision_tpu.config import ProjectionMode as JProjectionMode
from cybervision_tpu.ops import correlation as jc
from cybervision_tpu.ops import epipolar as je
from cybervision_tpu.ops import matching as jm
from cybervision_tpu.ops import pallas_ncc
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch import parallel
from cybervision_tpu_torch.images import SourceImage
from cybervision_tpu_torch.ops import correlation as tc
from cybervision_tpu_torch.ops import epipolar as te
from cybervision_tpu_torch.ops import matching as tm
from cybervision_tpu_torch.ops import ncc_sweep as k1
from cybervision_tpu_torch.parallel import Mesh, gather_rows, use_mesh
from cybervision_tpu_torch.reconstruction import reconstruct
from cybervision_tpu_torch.utils import prng

from .test_parallel import F_AFFINE, _pair
from .test_pipeline import _sem_pair
from .test_torch_pipeline import COUNT_RTOL, DEPTH_BUDGET, _port_fast_cfg, _read_ply
from .test_torch_ransac import _matches, _tables

torch.set_num_threads(2)

F_HSHIFT = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)
SWAP = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float64)
SWEEP_KW = dict(threshold=0.6, min_stdev=1.0, window=8, corridor_size=2)


def cpu_mesh(n: int) -> Mesh:
    return Mesh(("cpu",) * n)


def jax_mesh(n: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:n]), ("dev",))


def _sweep_fields(axis, h, w, dx=3):
    """The refine prologue's kernel inputs on a textured shift scene of
    h x w: rows are the epipolar lines ("horiz"), or columns ("vert": the
    transposed scene); the per-pixel form (None) takes the "horiz" fields
    with the axis flipped to vertical on a checkerboard of 8-pixel blocks."""
    hh, ww = (w, h) if axis == "vert" else (h, w)
    rng = np.random.RandomState(4)
    base = ndimage.gaussian_filter(rng.uniform(0, 255, (hh, ww + dx)), 1.5)
    base = np.round((base - base.min()) / np.ptp(base) * 255).astype(np.uint8)
    img1, img2 = base[:, :ww], base[:, dx : dx + ww]
    qy, qx = np.mgrid[0 : hh // 2, 0 : ww // 2]
    pos = np.stack([np.maximum(2 * qx - dx, 0), 2 * qy], axis=-1).astype(np.int32)
    f = F_HSHIFT
    if axis == "vert":
        img1, img2, pos, f = img1.T, img2.T, pos.transpose(1, 0, 2)[:, :, ::-1], SWAP @ F_HSHIFT @ SWAP
    prev = tc.CorrelationState(
        pos=torch.as_tensor(pos.copy()),
        corr=torch.ones(pos.shape[:2]),
        valid=torch.ones(pos.shape[:2], dtype=torch.bool),
    )
    wtr, tmin = tc.split_trange(tc.warp_shift_range(f, 1.0, h, w, h, w))
    assert wtr[0] == (axis or "horiz")
    fields = tc.sweep_inputs(
        torch.as_tensor(img1.copy()), torch.as_tensor(img2.copy()), prev,
        torch.as_tensor(f, dtype=torch.float32), 1.0, 1.0, 2.5, 1.0, 2,
        wtr, tmin, axis or "horiz",
    )
    if axis is None:
        yy, xx = np.mgrid[0:h, 0:w]
        fields["vert"] = torch.as_tensor(((yy // 8 + xx // 8) % 2).astype(np.float32))
    return fields, dict(SWEEP_KW, h2=h, w2=w, axis=axis)


def _sharded(mesh, fields, kw):
    return [gather_rows(o, "cpu") for o in k1.ncc_sweep_sharded(mesh, *fields.values(), **kw)]


# --- K1s: the row-sharded sweep ------------------------------------------------


@pytest.mark.parametrize("axis", ["vert", "horiz", None])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sharded_sweep_equals_unsharded(axis, n):
    """58 rows: 2, 3 and 4 shards leave zero-padded rows in the last one."""
    fields, kw = _sweep_fields(axis, 58, 40)
    ref = k1.ncc_sweep(*fields.values(), **kw)
    out = _sharded(cpu_mesh(n), fields, kw)
    assert torch.isfinite(ref[0]).float().mean() > 0.3
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("axis", ["vert", "horiz", None])
def test_sharded_sweep_matches_jax_sharded(axis):
    fields, kw = _sweep_fields(axis, 56, 40)
    out = _sharded(cpu_mesh(4), fields, kw)
    ref = pallas_ncc.ncc_sweep_sharded(
        jax_mesh(4), *(jnp.asarray(v.numpy()) for v in fields.values()),
        interpret=True, **kw,
    )
    ref = [np.asarray(r) for r in ref]
    ov, rv = np.isfinite(out[0].numpy()), np.isfinite(ref[0])
    assert (ov != rv).mean() < 0.005 and rv.mean() > 0.3
    v = ov & rv
    np.testing.assert_allclose(out[0].numpy()[v], ref[0][v], atol=1e-4)
    pos_eq = (out[1].numpy() == ref[1]) & (out[2].numpy() == ref[2])
    assert pos_eq[v].mean() > 0.995


def test_sharded_sweep_rejects_shallow_shards_and_stray_shards():
    fields, kw = _sweep_fields("horiz", 40, 32)
    with pytest.raises(ValueError, match="shallower than one halo"):
        k1.ncc_sweep_sharded(cpu_mesh(4), *fields.values(), **kw)
    shards = parallel.shard_rows(cpu_mesh(2), fields["img1"])
    with pytest.raises(AssertionError, match="do not span the mesh"):
        parallel.assert_spans_mesh(shards, cpu_mesh(3))


def test_shardable_rows_equals_jax():
    grid = [(r, n, wd) for r in (20, 33, 58, 64, 100, 128) for n in (1, 2, 3, 4, 8)
            for wd in (8, 16, 32)]
    assert [k1.shardable_rows(*g) for g in grid] == [pallas_ncc.shardable_rows(*g) for g in grid]
    assert k1.shardable_rows(128, 4, 16) and not k1.shardable_rows(64, 4, 16)


@pytest.mark.parametrize("axis", [0, 1])
def test_halo_attaches_neighbour_rows_and_zero_edges(axis):
    x = torch.arange(1, 3 * 11 * 4 + 1, dtype=torch.float32).reshape(3, 11, 4)
    if axis == 0:
        x = x[0]
    shards = parallel.shard_rows(cpu_mesh(3), x, axis=axis)
    assert (shards.h, shards.hs) == (11, 4)
    xp = torch.cat([x, torch.zeros_like(x.narrow(axis, 0, 1))], dim=axis)  # 12 rows
    m = 2
    parts = parallel.halo(shards, m)
    for i, p in enumerate(parts):
        assert p.shape[axis] == 4 + 2 * m
        for j in range(-m, 4 + m):
            g = 4 * i + j
            want = xp.narrow(axis, g, 1) if 0 <= g < 12 else torch.zeros_like(xp.narrow(axis, 0, 1))
            assert torch.equal(p.narrow(axis, j + m, 1), want), (i, j)
    assert torch.equal(gather_rows(shards, "cpu"), x)
    with pytest.raises(ValueError):
        parallel.halo(shards, 5)


# --- the dense path under a mesh ------------------------------------------------


def test_correlate_images_under_a_mesh_equals_unsharded_and_jax():
    """tests/test_parallel.py's 128x128 pair: the finest level shards
    (32-row shards over the 21-row halo), the coarse one does not."""
    src1, src2 = _pair(128, 128, 3.0)
    with use_mesh(cpu_mesh(4)):
        sharded = tc.correlate_images(src1, src2, F_AFFINE, tcfg.ProjectionMode.AFFINE, device="cpu")
    plan = tc._LAST_PLAN
    assert plan["mesh"] and plan["sharded_levels"] == [False, True], plan
    single = tc.correlate_images(
        src1, src2, F_AFFINE, tcfg.ProjectionMode.AFFINE, device="cpu", mesh=None
    )
    assert not tc._LAST_PLAN["mesh"]
    np.testing.assert_array_equal(sharded, single)
    ref = jc.correlate_images(src1, src2, F_AFFINE, JProjectionMode.AFFINE)
    np.testing.assert_array_equal(sharded, ref)
    assert sharded[:, :, 2].mean() > 0.5


# --- table-sharded matching ------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_matcher_equals_jax_and_unsharded(n):
    rng = np.random.RandomState(3)
    n1, n2 = 300, 517
    d1 = rng.randint(0, 2**32, (n1, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.randint(0, 2**32, (n2, 8), dtype=np.uint64).astype(np.uint32)
    # Ties across shards: copies of row 5 in the first and the last shard.
    d2[n2 - 1] = d2[5]
    v1, v2 = np.ones(n1, bool), np.ones(n2, bool)
    v2[7] = False
    gi, gd, gok = jm.match_descriptors_sharded(
        jax_mesh(n), jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2), 100
    )
    args = (torch.as_tensor(d1.view(np.int32)), torch.as_tensor(v1),
            torch.as_tensor(d2.view(np.int32)), torch.as_tensor(v2), 100)
    ti, td, tok = tm.match_descriptors_sharded(cpu_mesh(n), *args)
    si, sd, sok = tm.match_descriptors(*args)
    for out, ref in ((ti, gi), (td, gd), (tok, gok), (ti, si), (td, sd), (tok, sok)):
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert tok.any() and not tok.all()


# --- hypothesis-sharded RANSAC ---------------------------------------------------


def test_ransac_batch_sharded_with_jax_draws_picks_jax_winner():
    """JAX's draws, made by the port's own threefry from the same key,
    pick JAX's winner. tests/test_torch_ransac.py's scene: integral matches of a smooth
    disparity with 20 % outliers. (tests/test_parallel.py:178-204's pure
    translation is degenerate for the 4-point affine solver: every 3x3
    minor of its rank-2 system is exactly 0 when evaluated as written,
    as the port does; JAX's jitted solver turns them into rounding noise
    that happens to lie in the null space — ROADMAP.md Queue 3.)"""
    matches, _ = _matches(0)
    mpad, valid = _tables(matches)
    cfg = tcfg.RansacConfig()
    _, ns, t, d, _ = cfg.params(tcfg.ProjectionMode.AFFINE)
    top_limit = min(len(matches), cfg.top_inliers)
    packed = je.pack_coord_table(mpad)
    p1 = mpad[:, 0:2].astype(np.float32)
    p2 = mpad[:, 2:4].astype(np.float32)
    n, batch, key = 4, 4096, jax.random.PRNGKey(5)
    args = (top_limit, t, float(cfg.min_inlier_distance), d + ns)
    kw = dict(n_samples=ns, batch=batch, rank_eps=cfg.rank_epsilon)
    f_j, c_j, e_j = je.ransac_batch_sharded(
        jax_mesh(n), key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        *args, projection_affine=True, packed_t=jnp.asarray(packed), **kw,
    )
    # The same key, no draws handed over: each shard draws from its split.
    f_t, c_t, e_t = te.ransac_batch_sharded(
        cpu_mesh(n), prng.prng_key(5), torch.tensor(p1), torch.tensor(p2),
        torch.tensor(valid), *args, packed_t=torch.tensor(packed), **kw,
    )
    assert int(c_t[0]) == int(c_j[0]) > 400
    f_j = np.asarray(f_j[0], np.float64)
    np.testing.assert_allclose(f_t[0].double().numpy(), f_j, rtol=0, atol=1e-5 * np.abs(f_j).max())
    np.testing.assert_allclose(float(e_t[0]), float(e_j[0]), rtol=1e-5)


def test_find_fundamental_matrix_under_a_mesh_recovers_the_geometry():
    """The round loop with one key per shard keeps the planted inliers,
    like tests/test_torch_ransac.py's unsharded run; the shards draw
    different samples."""
    matches, inlier = _matches(3, m=800)
    cfg = tcfg.RansacConfig(
        ransac_k_affine=32768, check_interval=8192, ransac_d_early_exit_affine=200,
    )
    with use_mesh(cpu_mesh(4)):
        res = te.find_fundamental_matrix(
            matches, tcfg.ProjectionMode.AFFINE, 160.0, cfg, device="cpu"
        )
    assert res.matches_count == len(res.inliers) >= 0.95 * inlier.sum()
    keys = prng.split(prng.prng_key(0), 2)
    assert not torch.equal(prng.randint(keys[0], (8,), 0, 99), prng.randint(keys[1], (8,), 0, 99))


def test_find_fundamental_matrix_under_a_mesh_picks_jax_winner(monkeypatch):
    """The round loop under the JAX package's mesh of the conftest's 8
    devices (CVTPU_SHARD=1) and under an 8-shard CPU mesh in the port:
    the same round keys split over the same shards, the same winner."""
    matches, _ = _matches(2, m=700)
    kw = dict(ransac_k_affine=16384, check_interval=4096, ransac_d_early_exit_affine=10**6)
    monkeypatch.setenv("CVTPU_SHARD", "1")
    monkeypatch.delenv("CVTPU_NO_SHARD", raising=False)
    from cybervision_tpu.config import RansacConfig as JRansacConfig
    from cybervision_tpu.parallel import pipeline_mesh as jax_pipeline_mesh

    assert jax_pipeline_mesh().devices.size == 8
    ref = je.find_fundamental_matrix(matches, JProjectionMode.AFFINE, 160.0, JRansacConfig(**kw))
    monkeypatch.delenv("CVTPU_SHARD")
    with use_mesh(cpu_mesh(8)):
        out = te.find_fundamental_matrix(
            matches, tcfg.ProjectionMode.AFFINE, 160.0, tcfg.RansacConfig(**kw), device="cpu"
        )
    assert out.matches_count == ref.matches_count > 400
    np.testing.assert_allclose(out.f, ref.f, rtol=0, atol=1e-5 * np.abs(ref.f).max())
    np.testing.assert_array_equal(out.inliers, ref.inliers)


# --- the whole path under a mesh --------------------------------------------------


def test_reconstruct_under_a_mesh_matches_unsharded(tmp_path):
    img1, img2, _ = _sem_pair(np.random.RandomState(7))
    images = [SourceImage(img1), SourceImage(img2)]
    cfg = _port_fast_cfg(
        projection=tcfg.ProjectionMode.AFFINE, hardware=tcfg.HardwareMode.CPU,
        mesh=tcfg.MeshMode.VERTEX_COLORS,
    )
    names = ["a.png", "b.png"]
    out_s, out_u = str(tmp_path / "sharded.ply"), str(tmp_path / "single.ply")
    with use_mesh(cpu_mesh(2)):
        reconstruct(names, out_s, cfg, quiet=True, images=images)
        assert tc._LAST_PLAN["mesh"] and all(tc._LAST_PLAN["sharded_levels"][1:])
    with use_mesh(None):
        reconstruct(names, out_u, cfg, quiet=True, images=images)
        assert not tc._LAST_PLAN["mesh"]
    nv_u, _, cells_u = _read_ply(out_u)
    nv_s, nf_s, cells_s = _read_ply(out_s)
    assert nv_u > 3000 and nf_s > 3000
    assert abs(nv_s - nv_u) <= COUNT_RTOL * nv_u
    common = cells_u.keys() & cells_s.keys()
    assert len(common) >= (1 - COUNT_RTOL) * nv_u
    zu = np.array([cells_u[k] for k in common])
    zs = np.array([cells_s[k] for k in common])
    assert np.abs(zs - zu).mean() / (zu.max() - zu.min()) < DEPTH_BUDGET


def test_mesh_names_itself_and_holds_one_device_type():
    assert cpu_mesh(4).describe() == "4 shards on CPU"
    with pytest.raises(ValueError, match="does not hold cuda devices"):
        parallel.resolve_mesh(cpu_mesh(2), "cuda")


# --- choosing the mesh -------------------------------------------------------------


def test_pipeline_mesh_choice(monkeypatch):
    monkeypatch.delenv("CVTPU_NO_SHARD", raising=False)
    monkeypatch.delenv("CVTPU_SHARD_1DEV", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert parallel.pipeline_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = parallel.pipeline_mesh()
    assert mesh.size == 4 and mesh.axis_name == "dev"
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert parallel.pipeline_mesh(platform="cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.pipeline_mesh() is None
    monkeypatch.setenv("CVTPU_SHARD_1DEV", "1")
    assert parallel.pipeline_mesh().devices == (torch.device("cuda", 0),)
    monkeypatch.setenv("CVTPU_NO_SHARD", "1")
    assert parallel.pipeline_mesh() is None
    with use_mesh(cpu_mesh(3)) as m:
        assert parallel.pipeline_mesh() is m
        with use_mesh(None):
            assert parallel.pipeline_mesh() is None
        assert parallel.resolve_mesh(parallel.AUTO, "cpu") is m
    assert parallel.pipeline_mesh() is None
    assert os.environ["CVTPU_NO_SHARD"] == "1"
