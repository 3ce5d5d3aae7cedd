"""Affine RANSAC: the port (ops.epipolar with K2's and K3's plain
versions on the CPU) against the JAX package.

Tolerances: per-element Sampson errors are bitwise equal and scoring
counts equal (both evaluate sampson_error's operation order with every
product and sum rounded); error sums are within rtol 1e-5 of the exact
(f64) sum of those errors. score_candidates_xla's fused reduction is
itself off the exact sum by up to ~3e-4 relative on this table (XLA:CPU
contracts the linear forms into FMAs inside the fusion), so against it
the sums are held to 1e-4 of count * threshold. The gather is exact.
The port's threefry keys and draws (utils.prng) equal jax.random's bit
for bit, so from the same key one RANSAC batch, and the whole round
loop from the same seed, pick JAX's winner — equal count, F and mean
error within 1e-5 relative (f32 solver arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cybervision_tpu.config import ProjectionMode as JProjectionMode
from cybervision_tpu.config import RansacConfig as JRansacConfig
from cybervision_tpu.ops import epipolar as je
from cybervision_tpu.ops.pallas_score import score_candidates_xla
from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
from cybervision_tpu_torch.ops import epipolar as te
from cybervision_tpu_torch.ops import gather as tg
from cybervision_tpu_torch.ops import score as ts
from cybervision_tpu_torch.utils import prng
from cybervision_tpu_torch.utils.buckets import pow2_bucket

torch.set_num_threads(2)

SUM_RTOL = 1e-5
XLA_SUM_TOL = 1e-4
F_RTOL = 1e-5


def _matches(seed=0, m=600, outliers=0.2, size=160):
    """Integral (x1, y1, x2, y2) rows of a parallel-projection pair with a
    smooth horizontal disparity, plus random outliers."""
    rng = np.random.RandomState(seed)
    x1 = rng.randint(0, size, m)
    y1 = rng.randint(0, size, m)
    d = np.round(2.0 + 3.0 * (y1 / size) ** 2).astype(np.int64)
    x2 = np.clip(x1 - d, 0, size - 1)
    y2 = y1.copy()
    bad = rng.uniform(size=m) < outliers
    x2[bad] = rng.randint(0, size, bad.sum())
    y2[bad] = rng.randint(0, size, bad.sum())
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.int64), ~bad


def _tables(matches):
    m = len(matches)
    mb = pow2_bucket(m, floor=2048, factor=4)
    mpad = np.zeros((mb, 4), np.int64)
    mpad[:m] = matches
    valid = np.arange(mb) < m
    return mpad, valid


def _candidates(mpad, n, seed=1):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 500, (n, 4))
    s1 = mpad[idx, 0:2].astype(np.float32)
    s2 = mpad[idx, 2:4].astype(np.float32)
    f, valid = je.solve_affine_batch(jnp.asarray(s1), jnp.asarray(s2), 1e-3)
    return s1, s2, np.asarray(f), np.asarray(valid)


def test_solve_affine_batch_matches_jax():
    mpad, _ = _tables(_matches()[0])
    s1, s2, f_j, v_j = _candidates(mpad, 4096)
    f_t, v_t = te.solve_affine_batch(torch.as_tensor(s1), torch.as_tensor(s2), 1e-3)
    f_t, v_t = f_t.numpy(), v_t.numpy()
    assert (v_t != v_j).mean() < 1e-3 and v_j.mean() > 0.5
    both = v_t & v_j
    scale = np.abs(f_j[both]).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(f_t[both] / scale, f_j[both] / scale, atol=1e-4)


def test_score_plain_matches_xla():
    matches, _ = _matches()
    mpad, valid = _tables(matches)
    _, _, ff, _ = _candidates(mpad, 3000)
    p1 = mpad[:, 0:2].astype(np.float32)
    p2 = mpad[:, 2:4].astype(np.float32)
    t = JRansacConfig().params(JProjectionMode.AFFINE)[2]
    c_j, s_j = score_candidates_xla(
        jnp.asarray(ff), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), t
    )
    ff_t, p1_t, p2_t = torch.tensor(ff), torch.tensor(p1), torch.tensor(p2)
    c_t, s_t = ts.score_candidates(ff_t, p1_t, p2_t, torch.tensor(valid), t)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.max() > 400
    err = ts.sampson_error(ff_t, p1_t, p2_t).numpy()
    np.testing.assert_array_equal(
        err, np.asarray(je.sampson_error(jnp.asarray(ff), jnp.asarray(p1), jnp.asarray(p2)))
    )
    fits = np.isfinite(err) & (err <= t) & valid[None, :]
    exact = np.where(fits, err.astype(np.float64), 0.0).sum(axis=1)
    np.testing.assert_allclose(s_t.numpy(), exact, rtol=SUM_RTOL, atol=0)
    bound = XLA_SUM_TOL * c_t.numpy() * t
    assert np.all(np.abs(s_t.numpy() - np.asarray(s_j, np.float64)) <= bound)


def test_gather_plain_matches_take():
    matches, _ = _matches()
    mpad, _ = _tables(matches)
    packed = je.pack_coord_table(mpad)
    np.testing.assert_array_equal(te.pack_coord_table(mpad), packed)
    idx = np.random.RandomState(2).randint(0, 600, (13, 4, 3000)).astype(np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(packed), jnp.asarray(idx), axis=1))
    out = tg.gather_packed(torch.as_tensor(packed), torch.as_tensor(idx)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


SEEDS = [0, 1, 2**40 + 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), np.asarray(key).astype(np.int64))
    for n in (2, 4, 7):
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), n).numpy(),
            np.asarray(jax.random.split(key, n)).astype(np.int64),
        )
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(seed), (13, 7, 33)).numpy(),
        np.asarray(jax.random.bits(key, (13, 7, 33), jnp.uint32)).astype(np.int64),
    )


@pytest.mark.parametrize("top_limit", [1, 2, 1000, 13_066])
@pytest.mark.parametrize("shape", [(13, 4, 50), (13, 7, 33), (1,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, shape, top_limit):
    """The port's draws equal jax.random.randint's bit for bit (int32,
    JAX 0.9's partitionable threefry); the round keys of a RANSAC run
    come from split, held above."""
    ref = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, top_limit, dtype=jnp.int32)
    out = prng.randint(prng.prng_key(seed), shape, 0, top_limit)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _assert_same_winner(f_t, c_t, e_t, f_j, c_j, e_j):
    assert int(c_t) == int(c_j) > 400
    f_j, f_t = np.asarray(f_j, np.float64), np.asarray(f_t, np.float64)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=F_RTOL * np.abs(f_j).max())
    if e_j is not None:
        np.testing.assert_allclose(float(e_t), float(e_j), rtol=F_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_batch_with_jax_draws_picks_jax_winner(seed):
    """One batch from the same key, no draws handed over: the port makes
    JAX's draws itself (utils.prng) and picks JAX's winner."""
    matches, _ = _matches(seed)
    mpad, valid = _tables(matches)
    cfg = JRansacConfig()
    _, n, t, d, _ = cfg.params(JProjectionMode.AFFINE)
    top_limit = min(len(matches), cfg.top_inliers)
    batch = 4096
    key = jax.random.PRNGKey(seed)
    p1 = mpad[:, 0:2].astype(np.float32)
    p2 = mpad[:, 2:4].astype(np.float32)
    packed = je.pack_coord_table(mpad)
    f_j, c_j, e_j = je._ransac_batch_core(
        key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), top_limit, t,
        float(cfg.min_inlier_distance), d + n, n_samples=n, batch=batch,
        projection_affine=True, rank_eps=cfg.rank_epsilon,
        packed_t=jnp.asarray(packed),
    )
    f_t, c_t, e_t = te._ransac_batch_core(
        prng.prng_key(seed), torch.tensor(p1), torch.tensor(p2), torch.tensor(valid),
        top_limit, t, float(cfg.min_inlier_distance), d + n, n_samples=n,
        batch=batch, rank_eps=cfg.rank_epsilon, packed_t=torch.tensor(packed),
    )
    _assert_same_winner(f_t[0], c_t[0], e_t[0], f_j[0], c_j[0], e_j[0])


@pytest.mark.parametrize("early_exit", [200, 10**6])
def test_find_fundamental_matrix_picks_jax_winner(early_exit):
    """The whole round loop from RansacConfig.seed: one split of the key
    per round, as the JAX package does. An early exit of 200 stops after
    the first round; an unreachable one runs all four (JAX fuses them
    into one program over the same round keys)."""
    matches, _ = _matches(2, m=700)
    kw = dict(ransac_k_affine=16384, check_interval=4096, ransac_d_early_exit_affine=early_exit)
    ref = je.find_fundamental_matrix(matches, JProjectionMode.AFFINE, 160.0, JRansacConfig(**kw))
    out = te.find_fundamental_matrix(
        matches, ProjectionMode.AFFINE, 160.0, RansacConfig(**kw), device="cpu"
    )
    _assert_same_winner(out.f, out.matches_count, None, ref.f, ref.matches_count, None)
    np.testing.assert_array_equal(out.inliers, ref.inliers)


def test_find_fundamental_matrix_recovers_the_geometry():
    """The port's round loop: the winner keeps the planted inliers, like
    JAX's find_fundamental_matrix on the table."""
    matches, inlier = _matches(3, m=800)
    kw = dict(ransac_k_affine=32768, check_interval=8192, ransac_d_early_exit_affine=200)
    ref = je.find_fundamental_matrix(matches, JProjectionMode.AFFINE, 160.0, JRansacConfig(**kw))
    out = te.find_fundamental_matrix(
        matches, ProjectionMode.AFFINE, 160.0, RansacConfig(**kw), device="cpu"
    )
    assert out.f.shape == (3, 3) and out.f.dtype == np.float64
    assert out.matches_count == len(out.inliers)
    assert out.matches_count >= 0.95 * inlier.sum()
    assert abs(out.matches_count - ref.matches_count) <= 0.02 * ref.matches_count


def test_not_enough_matches_raises():
    matches, _ = _matches(m=5)
    with pytest.raises(ValueError, match="Not enough matches"):
        te.find_fundamental_matrix(matches, ProjectionMode.AFFINE, 160.0, device="cpu")
