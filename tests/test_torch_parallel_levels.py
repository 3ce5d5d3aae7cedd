"""The port's row-sharded pyramid levels and sharded P3P scoring on CPU
meshes, against the unsharded port and the JAX package.

A CPU mesh is several shards on the CPU device (parallel.Mesh allows a
repeated device): each shard resizes, runs the first pass or the refine
prologue, sweeps and cross-checks its own rows for real, reading its
neighbours' rows through halos and all-gathers.

Tolerances: none. A sharded level equals the unsharded port bit for bit
(state planes equal), for the first and a refine level, both directions,
2, 3 and 4 shards, the 128x128 pair of tests/test_parallel.py, a 131-row
pair that no shard count divides, and its radial-flow pair (mixed axes:
K1's per-pixel form); so do the corridors of a 300x260 level whose
128-row anchor bands straddle the shard edges, and both cross-checks
with matches pointing across shard edges. P3P scoring under a mesh
equals the unsharded port exactly, and the JAX package's sharded scorer
in counts and gates exactly and in errors to tests/test_torch_sfm.py's
rtol of 1e-5 (each package's float32 reprojection rounds its own way).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from scipy import ndimage

from cybervision_tpu.ops import sfm_device as jsd
from cybervision_tpu_torch import config as tcfg
from cybervision_tpu_torch.ops import correlation as tc
from cybervision_tpu_torch.ops import sfm_device as tsd
from cybervision_tpu_torch.parallel import Mesh, RowShards, assert_spans_mesh

from .test_parallel import F_AFFINE, _Img, _pair

torch.set_num_threads(2)

F_RADIAL = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float64)
CPU = torch.device("cpu")


def cpu_mesh(n: int) -> Mesh:
    return Mesh(("cpu",) * n)


def _radial(h: int, w: int):
    """tests/test_parallel.py's forward-motion pair: img2 is img1 zoomed
    about the (0, 0) epipole, the lines of F_RADIAL radiate from it, so
    the sweep axis mixes across the image."""
    rng = np.random.RandomState(5)
    base = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img2 = ndimage.map_coordinates(base, [ys / 1.01, xs / 1.01], order=3, mode="nearest")
    return _Img(base), _Img(img2)


SCENES = {
    "affine 128x128": (lambda: _pair(128, 128, 3.0), F_AFFINE, tcfg.ProjectionMode.AFFINE),
    "affine 131x136": (lambda: _pair(131, 136, 3.0), F_AFFINE, tcfg.ProjectionMode.AFFINE),
    "radial 131x136": (lambda: _radial(131, 136), F_RADIAL, tcfg.ProjectionMode.PERSPECTIVE),
}


def _params(proj):
    cc = tcfg.CorrelationConfig()
    return (cc.threshold(proj), cc.min_stdev(proj), cc.corridor_min_range(proj),
            cc.corridor_extend_range(proj), cc.corridor_size(proj))


def _new_plan(monkeypatch):
    plan = {"mesh": True, "sharded_levels": [], "sharded_prologue": [], "windows": []}
    monkeypatch.setattr(tc, "_LAST_PLAN", plan)
    return plan


def _whole(state):
    return [t.numpy() for t in tc.gather_state(state, CPU)]


def _assert_states_equal(a, b):
    for x, y in zip(_whole(a), _whole(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _spans(state, mesh):
    for t in state:
        assert isinstance(t, RowShards)
        assert_spans_mesh(t, mesh)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """A pair's two-level pyramid run unsharded: the first level's and
    the refine level's states, with each level's windows from the
    corridors' reach."""
    make, f, proj = SCENES[name]
    src1, src2 = make()
    f = tc.normalize_f(f)
    pair = tc._Pair((CPU,), src1.img, src2.img, f)
    levels = [tc._plan_level(f, s, src1.img.shape, src2.img.shape)
              for s in tcfg.pyramid_scales(src1.img.shape[::-1], 64)]
    assert len(levels) == 2
    params = _params(proj)
    tc._LAST_PLAN = {"mesh": False, "sharded_levels": [], "sharded_prologue": [], "windows": []}
    first = tc._level_step(pair, None, None, levels[0], params, 16, 16, True)
    wins = tuple(tc._bucket(r, tcfg.CorrelationConfig())
                 for r in tc._reach_pair(pair, *first, levels[1], params, None))
    refine = tc._level_step(pair, *first, levels[1], params, *wins, False)
    assert tc._LAST_PLAN["sharded_prologue"] == [False, False]
    assert _whole(refine[0])[2].mean() > 0.5
    return dict(name=name, pair=pair, levels=levels, params=params,
                first=first, refine=refine, wins=wins)


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    return _scene(request.param)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_levels_equal_the_unsharded_port(scene, n, monkeypatch):
    """The first level and the refine level over an n-shard mesh: every
    state spans the mesh and equals the unsharded one bit for bit; the
    refine level reads the sharded first level's states (nothing is
    gathered between levels), and its sweeps run as K1s."""
    mesh = cpu_mesh(n)
    plan = _new_plan(monkeypatch)
    pair, levels, params = scene["pair"], scene["levels"], scene["params"]
    first = tc._level_step(pair, None, None, levels[0], params, 16, 16, True, mesh)
    for st, ref in zip(first, scene["first"]):
        _spans(st, mesh)
        _assert_states_equal(st, ref)
    wins = tuple(tc._bucket(r, tcfg.CorrelationConfig())
                 for r in tc._reach_pair(pair, *first, levels[1], params, mesh))
    assert wins == scene["wins"]
    refine = tc._level_step(pair, *first, levels[1], params, *wins, False, mesh)
    for st, ref in zip(refine, scene["refine"]):
        _spans(st, mesh)
        _assert_states_equal(st, ref)
    assert plan["sharded_prologue"] == [True, True]
    assert plan["sharded_levels"] == [False, True]
    if scene["name"].startswith("radial"):
        assert levels[1].fv_f is None and levels[1].fv_r is None  # the per-pixel form


def test_refine_level_with_shards_under_one_sweep_halo_runs_k1_on_the_lead(monkeypatch):
    """Window 32 over 4 shards of a 128-row level: the prologue and the
    cross-checks run sharded, the shards are shallower than K1's halo
    (37 rows), so the fields are gathered and K1 runs on the lead; the
    result still equals the unsharded level."""
    scene = _scene("affine 128x128")
    mesh = cpu_mesh(4)
    pair, levels, params = scene["pair"], scene["levels"], scene["params"]
    tc._LAST_PLAN = {"mesh": False, "sharded_levels": [], "sharded_prologue": [], "windows": []}
    ref = tc._level_step(pair, *scene["first"], levels[1], params, 32, 32, False)
    plan = _new_plan(monkeypatch)
    out = tc._level_step(pair, *scene["first"], levels[1], params, 32, 32, False, mesh)
    assert plan["sharded_prologue"] == [True] and plan["sharded_levels"] == [False]
    for st, r in zip(out, ref):
        _spans(st, mesh)
        _assert_states_equal(st, r)


def test_correlate_images_radial_under_a_mesh_equals_unsharded():
    """The whole pyramid of the radial pair over 3 shards (131 rows: the
    last shard holds 43 rows and one padding row): every level runs
    row-sharded, the refine sweeps as K1s' per-pixel form."""
    src1, src2 = _radial(131, 136)
    proj = tcfg.ProjectionMode.PERSPECTIVE
    single = tc.correlate_images(src1, src2, F_RADIAL, proj, device="cpu", mesh=None)
    sharded = tc.correlate_images(src1, src2, F_RADIAL, proj, device="cpu", mesh=cpu_mesh(3))
    plan = tc._LAST_PLAN
    assert plan["mesh"] and plan["sharded_prologue"] == [True, True], plan
    assert plan["sharded_levels"] == [False, True], plan
    np.testing.assert_array_equal(sharded, single)
    assert single[:, :, 2].mean() > 0.5


def _prev_state(rng, h, w, spread):
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack([2 * xs + 5 + rng.randint(-spread, spread + 1, (h, w)),
                    2 * ys - 3 + rng.randint(-spread, spread + 1, (h, w))], axis=-1)
    pos = np.clip(pos, 0, None).astype(np.int32)
    valid = rng.uniform(size=(h, w)) < 0.8
    corr = rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    return tc.CorrelationState(torch.as_tensor(pos), torch.as_tensor(corr), torch.as_tensor(valid))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("f", [F_AFFINE, F_RADIAL], ids=["affine", "radial"])
def test_corridors_with_anchor_bands_across_shard_edges_equal_unsharded(n, f):
    """A 300x260 level: two 128-row anchor bands and a 44-row one, two
    128-column bands and a 4-column one. Over 2, 3 or 4 shards (150, 100
    or 75 rows) the bands straddle the shard edges; the band means
    reduce every shard's row partials in one order, so each shard's
    center, start, end and has_neighbors, and the reach, equal the
    unsharded corridors bit for bit."""
    rng = np.random.RandomState(8)
    h, w = 300, 260
    prev = _prev_state(rng, h // 2, w // 2, 6)
    fs = {CPU: torch.as_tensor(tc.normalize_f(f), dtype=torch.float32)}
    one = Mesh((CPU,))
    kw = dict(h=h, w=w, h2=h, w2=w, scale=1.0, min_range=2.5, extend_range=1.0, force_vert=None)
    ref = tc._corridors(one, tc._state_on(one, prev), fs, **kw)
    mesh = cpu_mesh(n)
    out = tc._corridors(mesh, tc._state_on(mesh, prev), fs, **kw)
    hs = -(-h // n)
    for name in ("center", "start", "end", "has"):
        got = torch.cat([getattr(c, name) for c in out])[:h]
        want = getattr(ref[0], name)
        assert torch.equal(got, want), name
    vert = ref[0].ep["vert"]
    assert bool(vert.any()) == (f is F_RADIAL) and not bool(vert.all())
    assert any((b * 128) % hs for b in (1, 2))  # a band edge inside a shard
    assert int(tc._reach(out, h)) == int(tc._reach(ref, h)) > 0


def _match_states(rng, h, w, hr, wr, inv_s, spread, spread_back):
    """A forward state whose matches scatter +-spread cells around the
    diagonal (across the reverse plane's shard edges) and a reverse state
    pointing back with +-spread_back."""
    def state(h, w, h_to, w_to, spread):
        ys, xs = np.mgrid[0:h, 0:w]
        pos = np.stack([xs + rng.randint(-spread, spread + 1, (h, w)),
                        ys + rng.randint(-spread, spread + 1, (h, w))], axis=-1)
        pos = (np.clip(pos, 0, [w_to - 1, h_to - 1]) * inv_s).astype(np.int32)
        valid = rng.uniform(size=(h, w)) < 0.85
        corr = rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
        return tc.CorrelationState(torch.as_tensor(pos), torch.as_tensor(corr), torch.as_tensor(valid))
    return state(h, w, hr, wr, spread), state(hr, wr, h, w, spread_back)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("exact", [False, True], ids=["cross_check", "cross_check_exact"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_cross_checks_across_shard_edges_equal_unsharded(n, exact, scale):
    """A 70x50 forward state against a 67x54 reverse one whose matches
    scatter up to 9 cells (past the +-4-cell windows, across shard
    edges) and point back within 16, in both orders: the sharded check (reverse bounds dilated per
    shard with a 4-row halo, or packed, then all-gathered) equals the
    whole-plane check bit for bit."""
    rng = np.random.RandomState(12)
    inv_s = int(round(1 / scale))
    fwd, rev = _match_states(rng, 70, 50, 67, 54, inv_s, 9, 16)
    check = tc.cross_check_exact if exact else tc.cross_check
    mesh = cpu_mesh(n)
    hs = -(-67 // n)
    rows = fwd.pos[:, :, 1] // inv_s
    assert bool(((rows // hs) != (torch.arange(70)[:, None] // -(-70 // n))).any())
    ref_f = check(fwd, rev, scale)
    ref_r = check(rev, ref_f, scale)
    out_f = tc._cross_check_level(mesh, tc._state_on(mesh, fwd), tc._state_on(mesh, rev), scale, exact)
    out_r = tc._cross_check_level(mesh, tc._state_on(mesh, rev), out_f, scale, exact)
    for out, ref in ((out_f, ref_f), (out_r, ref_r)):
        _spans(out, mesh)
        _assert_states_equal(out, ref)
    kept, valid = int(ref_f.valid.sum()), int(fwd.valid.sum())
    assert 0 < kept < valid if exact else 0 < kept <= valid


# --- P3P scoring over a mesh ----------------------------------------------------


def _p3p_scene(b):
    """tests/test_parallel.py:228-258's scene: 700 noisy tracks of a
    camera at the origin, b candidates near the true projection."""
    rng = np.random.RandomState(11)
    t = 700
    pts3d = rng.normal(0, 1, (t, 3)) + np.array([0, 0, 5.0])
    k = np.array([[300.0, 0, 160], [0, 300.0, 128], [0, 0, 1]])
    proj_true = k @ np.hstack([np.eye(3), np.zeros((3, 1))])
    h3 = np.concatenate([pts3d, np.ones((t, 1))], axis=1)
    uv = h3 @ proj_true.T
    pts2d = uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.5, (t, 2))
    const_err = np.zeros(t)
    proj = proj_true[None] + rng.normal(0, 0.01, (b, 3, 4))
    proj[7] = np.nan
    samp = rng.randint(0, t, (b, 3))
    return (proj, pts2d[samp], pts3d[samp], pts3d, pts2d, const_err, 50.0, 25.0)


def _jax_sharded(n, args, chunk):
    """The JAX package's _p3p_score_sharded over n of the conftest's
    virtual devices, with its host wrapper's padding (track axis to a
    power of two with infinite constant error, candidates to a multiple
    of chunk x n with NaN projections)."""
    proj, s2d, s3d, pts3d, pts2d, const_err, inlier_t, points_t = args
    b, t = len(proj), len(pts3d)
    tb = 1 << max(t - 1, 0).bit_length()
    pad3 = np.zeros((tb, 3), np.float32)
    pad3[:t] = pts3d
    pad2 = np.zeros((tb, 2), np.float32)
    pad2[:t] = pts2d
    cerr = np.full((tb,), np.inf, np.float32)
    cerr[:t] = const_err
    bp = -(-b // (chunk * n)) * chunk * n
    proj_p = np.full((bp, 3, 4), np.nan, np.float32)
    proj_p[:b] = proj
    s2d_p = np.zeros((bp, 3, 2), np.float32)
    s2d_p[:b] = s2d
    s3d_p = np.zeros((bp, 3, 3), np.float32)
    s3d_p[:b] = s3d
    mesh = JMesh(np.array(jax.devices()[:n]), ("dev",))
    out = jsd._p3p_score_sharded(
        mesh, *(jnp.asarray(a) for a in (proj_p, s2d_p, s3d_p, pad3, pad2, cerr)),
        jnp.float32(inlier_t), jnp.float32(points_t), chunk=chunk,
    )
    return [np.asarray(o)[:b] for o in out]


@pytest.mark.parametrize("n", [2, 3])
def test_p3p_score_under_a_mesh_equals_unsharded_and_jax(n, monkeypatch):
    """B = 1,000 candidates in chunks of 64 (no multiple of 64 x n, nor of
    the 128 x n blocks the port cuts): the n shards each score a block,
    the result equals the unsharded port exactly and JAX's sharded scorer
    (counts and gates exactly, errors to rtol 1e-5)."""
    args = _p3p_scene(1000)
    single = tsd.p3p_score(*args, chunk=64, device="cpu")
    monkeypatch.setattr(tsd, "launches", 0)
    monkeypatch.setattr(tsd, "sharded_launches", 0)
    sharded = tsd.p3p_score(*args, chunk=64, device="cpu", mesh=cpu_mesh(n))
    assert (tsd.launches, tsd.sharded_launches) == (n, 1)
    for a, b in zip(sharded, single):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    count, err_max, ok = _jax_sharded(n, args, 64)
    np.testing.assert_array_equal(sharded[0], count)
    np.testing.assert_array_equal(sharded[2], ok)
    np.testing.assert_allclose(sharded[1], err_max, rtol=1e-5)
    assert sharded[0].max() > 0 and sharded[0][7] == 0 and not sharded[2][7]
