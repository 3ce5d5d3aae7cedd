"""Dense correlation: the port (ops.correlation, with K1's plain sweep on
the CPU) against the JAX package on the same inputs.

Tolerances: the sweep's are tests/test_pallas_ncc.py's (under 0.5 % of
valid flags differ, corr within atol 1e-4 where both are valid, over
99.5 % of positions equal — f32 box sums in another order flip
threshold-boundary pixels); the whole pyramid is held to the golden
fixture's 1 % depth budget (tests/test_golden_parity.py) and to the JAX
pipeline by the same flip/position bounds. Integer and host-side pieces
(resize, packing, cross-check, warp buckets) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cybervision_tpu.config import CorrelationConfig as JCorrelationConfig
from cybervision_tpu.config import ProjectionMode as JProjectionMode
from cybervision_tpu.ops import correlation as jc
from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode
from cybervision_tpu_torch.interop import correlation_state_from_numpy
from cybervision_tpu_torch.ops import correlation as tc

from .golden_scene import F_HSHIFT, SCALE_MIN_SIZE, golden_scene

torch.set_num_threads(2)

FLIP_MAX = 0.005
CORR_ATOL = 1e-4
POS_EQ_MIN = 0.995

F_VSHIFT = np.array([[0, 0, 1], [0, 0, 0], [-1, 0, 0]], dtype=np.float64)
# Epipolar lines whose dominant axis changes inside a 48x40 image
# (|a| > |b| only for x < 10 and x > 30): the per-pixel form's axis
# choice and cross-axis gate.
F_MIXED = np.array([[0.05, 0, -1.0], [0, 0, 0.5], [0, -1, 0]], dtype=np.float64)


class _Src:
    def __init__(self, img):
        self.img = img


def _scene(rng, h, w, dx):
    """tests/test_pallas_ncc.py's sweep scene."""
    base = rng.uniform(0, 255, (h, w + dx))
    base = ndimage.gaussian_filter(base, 1.5)
    base = np.round(
        (base - base.min()) / (base.max() - base.min()) * 255
    ).astype(np.uint8)
    return base[:, :w].copy(), base[:, dx : dx + w].copy()


def _sweep_case(rng, name):
    """(img1, img2, prev_pos (h/2, w/2, 2), F) of a 48x40 sweep scene."""
    if name == "vert":
        h, w, d = 40, 48, 2
        a, b = _scene(rng, w, h, d)
        img1, img2, f = a.T.copy(), b.T.copy(), F_VSHIFT
    else:
        h, w, d = 48, 40, 2
        img1, img2 = _scene(rng, h, w, d)
        f = F_MIXED if name == "mixed" else F_HSHIFT
    qy, qx = np.mgrid[0 : h // 2, 0 : w // 2]
    if name == "vert":
        pos = np.stack([2 * qx, np.maximum(2 * qy - d, 0)], axis=-1)
    else:
        pos = np.stack([np.maximum(2 * qx - d, 0), 2 * qy], axis=-1)
    return img1, img2, pos.astype(np.int32), f


def _assert_states_agree(out_valid, ref_valid, out_pos, ref_pos, out_corr=None, ref_corr=None):
    assert (out_valid != ref_valid).mean() < FLIP_MAX
    v = out_valid & ref_valid
    assert v.sum() > 0
    if out_corr is not None:
        np.testing.assert_allclose(out_corr[v], ref_corr[v], atol=CORR_ATOL)
    assert (out_pos[v] == ref_pos[v]).all(axis=-1).mean() > POS_EQ_MIN


@pytest.mark.parametrize(
    "name,static",
    [("horiz", True), ("horiz", False), ("vert", True), ("vert", False), ("mixed", False)],
)
def test_refine_pass_matches_jax(rng, name, static):
    """Port refine_pass (K1's plain sweep) vs JAX refine_pass: the static
    "horiz"/"vert" forms (shift/select warps) and the per-pixel form
    (gather warps, per-pixel axis)."""
    img1, img2, pos, f = _sweep_case(rng, name)
    h, w = img1.shape
    hp, wp = pos.shape[:2]
    kw = {}
    if static:
        wtr, tmin = jc.split_trange(jc.warp_shift_range(f, 1.0, h, w, h, w))
        assert wtr is not None and wtr[0] == name
        assert tc.split_trange(tc.warp_shift_range(f, 1.0, h, w, h, w)) == (wtr, tmin)
        kw = {"warp_trange": wtr, "warp_tmin": tmin}
    jprev = jc.CorrelationState(
        pos=jnp.asarray(pos), corr=jnp.ones((hp, wp), jnp.float32),
        valid=jnp.ones((hp, wp), bool),
    )
    ref = jc.refine_pass(
        jnp.asarray(img1), jnp.asarray(img2), jprev, jnp.asarray(f, jnp.float32),
        1.0, 0.6, 1.0, 2.5, 1.0, 2, window=8, **kw,
    )
    tprev = correlation_state_from_numpy(pos, np.ones((hp, wp)), np.ones((hp, wp), bool))
    out = tc.refine_pass(
        torch.as_tensor(img1), torch.as_tensor(img2), tprev,
        torch.as_tensor(f, dtype=torch.float32), 1.0, 0.6, 1.0, 2.5, 1.0, 2,
        window=8, **kw,
    )
    if name == "mixed":
        vert = np.asarray(jc.epipolar_fields(jnp.asarray(f, jnp.float32), h, w, 1.0)["vert"])
        assert vert.any() and not vert.all()
    _assert_states_agree(
        out.valid.numpy(), np.asarray(ref.valid), out.pos.numpy(),
        np.asarray(ref.pos), out.corr.numpy(), np.asarray(ref.corr),
    )
    # Not vacuous: the mixed geometry leaves fewer corridors in bounds.
    assert out.valid.numpy().mean() > (0.05 if name == "mixed" else 0.2)


def test_refine_pass_matches_jax_at_window_192(rng):
    """A window wider than one block of the card's tiled sweep holds (the
    kernel sweeps it in two chunks of offsets): the plain sweep against
    JAX's refine_pass (its scan, which the JAX package also takes for a
    level whose tile does not fit) on a 40x420 scene, wide enough for
    the shifts, with the sweep's tolerances."""
    h, w, d = 40, 420, 2
    img1, img2 = _scene(rng, h, w, d)
    qy, qx = np.mgrid[0 : h // 2, 0 : w // 2]
    pos = np.stack([np.maximum(2 * qx - d, 0), 2 * qy], axis=-1).astype(np.int32)
    wtr, tmin = jc.split_trange(jc.warp_shift_range(F_HSHIFT, 1.0, h, w, h, w))
    kw = {"warp_trange": wtr, "warp_tmin": tmin, "window": 192}
    args = (1.0, 0.6, 1.0, 2.5, 1.0, 2)
    jprev = jc.CorrelationState(
        pos=jnp.asarray(pos), corr=jnp.ones(pos.shape[:2], jnp.float32),
        valid=jnp.ones(pos.shape[:2], bool),
    )
    ref = jc.refine_pass(
        jnp.asarray(img1), jnp.asarray(img2), jprev, jnp.asarray(F_HSHIFT, jnp.float32), *args, **kw,
    )
    tprev = correlation_state_from_numpy(pos, np.ones(pos.shape[:2]), np.ones(pos.shape[:2], bool))
    out = tc.refine_pass(
        torch.as_tensor(img1), torch.as_tensor(img2), tprev,
        torch.as_tensor(F_HSHIFT, dtype=torch.float32), *args, **kw,
    )
    _assert_states_agree(
        out.valid.numpy(), np.asarray(ref.valid), out.pos.numpy(),
        np.asarray(ref.pos), out.corr.numpy(), np.asarray(ref.corr),
    )
    assert out.valid.numpy().mean() > 0.2


def test_first_pass_matches_jax():
    img1, img2, _ = golden_scene()
    a = np.ascontiguousarray(img1[::2, ::2])
    b = np.ascontiguousarray(img2[::2, ::2])
    cc = JCorrelationConfig()
    aff = JProjectionMode.AFFINE
    args = (0.5, cc.threshold(aff), cc.min_stdev(aff))
    ref = jc.first_pass(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(F_HSHIFT, jnp.float32),
        *args, cc.corridor_size(aff),
    )
    out = tc.first_pass(
        torch.as_tensor(a), torch.as_tensor(b),
        torch.as_tensor(F_HSHIFT, dtype=torch.float32), *args,
        cc.corridor_size(aff),
    )
    _assert_states_agree(
        out.valid.numpy(), np.asarray(ref.valid), out.pos.numpy(),
        np.asarray(ref.pos), out.corr.numpy(), np.asarray(ref.corr),
    )


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.125])
def test_device_resize_matches_jax(scale):
    """Lanczos3, truncated dims, u8 quantisation: exact, odd sizes too."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (149, 131)).astype(np.uint8)
    ref = np.asarray(jc._device_resize(jnp.asarray(img), scale))
    out = tc.device_resize(torch.as_tensor(img), scale).numpy()
    assert out.shape == ref.shape == tc.resized_shape(img.shape, scale)
    np.testing.assert_array_equal(out, ref)


def _random_state(rng, h, w, inv_s, spread):
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack(
        [xs * inv_s + rng.randint(-spread, spread + 1, (h, w)),
         ys * inv_s + rng.randint(-spread, spread + 1, (h, w))], axis=-1,
    )
    pos = np.clip(pos, 0, None).astype(np.int32)
    valid = rng.uniform(size=(h, w)) < 0.8
    corr = rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    return pos, corr, valid


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_cross_check_matches_jax(scale):
    """The interval-bound mutual-consistency filter: exact."""
    rng = np.random.RandomState(5)
    inv_s = int(round(1 / scale))
    fwd = _random_state(rng, 30, 26, inv_s, 12)
    rev = _random_state(rng, 28, 27, inv_s, 12)
    ref = jc.cross_check(
        jc.CorrelationState(*(jnp.asarray(x) for x in fwd)),
        jc.CorrelationState(*(jnp.asarray(x) for x in rev)), scale,
    )
    out = tc.cross_check(
        correlation_state_from_numpy(*fwd), correlation_state_from_numpy(*rev), scale
    )
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(out.corr.numpy(), np.asarray(ref.corr))


def test_pack_state_delta_matches_jax():
    rng = np.random.RandomState(9)
    pos, corr, valid = _random_state(rng, 24, 20, 1, 40)
    st_j = jc.CorrelationState(*(jnp.asarray(x) for x in (pos, corr, valid)))
    st_t = correlation_state_from_numpy(pos, corr, valid)
    d16_j, word_j = jc._pack_state_delta(st_j)
    d16_t, word_t = tc.pack_state_delta(st_t)
    np.testing.assert_array_equal(word_t.numpy(), np.asarray(word_j))
    np.testing.assert_array_equal(
        d16_t.numpy().astype(np.uint16), np.asarray(d16_j)
    )
    # Without an overflow the host inverse restores the word plane.
    small = np.clip(pos, np.stack(np.mgrid[0:24, 0:20][::-1], -1) - 60, None)
    small = np.minimum(small, np.stack(np.mgrid[0:24, 0:20][::-1], -1) + 60)
    d16, word = tc.pack_state_delta(correlation_state_from_numpy(small, corr, valid))
    d16 = d16.numpy().astype(np.uint16)
    assert not d16[0, 0] & 0x8000
    got = tc.unpack_delta_grid(d16)
    np.testing.assert_array_equal(got[valid], word.numpy()[valid])
    np.testing.assert_array_equal(got, jc.unpack_delta_grid(d16))


@pytest.mark.parametrize(
    "f",
    [F_HSHIFT, F_VSHIFT, F_MIXED,
     np.array([[1e-3, 2e-4, -0.3], [-3e-4, 1e-3, 0.9], [0.2, -1.0, 5.0]])],
)
def test_host_decisions_match_jax(f):
    """Warp buckets, uniform axes and the f32 epipolar fields: exact."""
    for scale, (h, w) in ((1.0, (48, 40)), (0.25, (12, 10))):
        assert tc.warp_shift_range(f, scale, h, w, h, w) == jc.warp_shift_range(
            f, scale, h, w, h, w
        )
        assert tc.uniform_epipolar_axis(f, scale, h, w) == jc.uniform_epipolar_axis(
            f, scale, h, w
        )
        ref = jc.epipolar_fields(jnp.asarray(f, jnp.float32), h, w, scale)
        out = tc.epipolar_fields(torch.as_tensor(f, dtype=torch.float32), h, w, scale)
        for k in ("vert", "coeff", "add", "finite"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def _correlate_port(fixed=16):
    img1, img2, _ = golden_scene()
    cfg = CorrelationConfig(scale_min_size=SCALE_MIN_SIZE, corridor_window_fixed=fixed)
    return tc.correlate_images(
        _Src(img1), _Src(img2), F_HSHIFT, ProjectionMode.AFFINE, cfg, device="cpu"
    )


@pytest.fixture(scope="module")
def golden():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden_dense.npz"))


def test_correlate_images_meets_golden_budget(golden):
    """tests/test_golden_parity.py's budget: mask IoU > 0.85, positions
    within 1 px > 95 %, normalised mean depth delta < 1 %."""
    out = _correlate_port()
    mine = out[:, :, 2] == 1
    ref = golden["valid"]
    both = mine & ref
    assert both.sum() / (mine | ref).sum() > 0.85
    dx = np.abs(out[:, :, 0][both] - golden["pos_x"][both])
    dy = np.abs(out[:, :, 1][both] - golden["pos_y"][both])
    assert ((dx <= 1) & (dy <= 1)).mean() > 0.95
    ys, xs = np.nonzero(both)
    d_mine = np.hypot(xs - out[:, :, 0][both], ys - out[:, :, 1][both])
    d_ref = np.hypot(xs - golden["pos_x"][both], ys - golden["pos_y"][both])
    assert np.abs(d_mine - d_ref).mean() / (d_ref.max() - d_ref.min()) < 0.01


@pytest.mark.parametrize("fixed", [16, None])
def test_correlate_images_matches_jax(fixed):
    """The fixed-window pyramid and the data-driven bucket path against
    the JAX pipeline on the golden scene."""
    img1, img2, _ = golden_scene()
    jcfg = JCorrelationConfig(scale_min_size=SCALE_MIN_SIZE, corridor_window_fixed=fixed)
    ref = jc.correlate_images(
        _Src(img1), _Src(img2), F_HSHIFT, JProjectionMode.AFFINE, jcfg
    )
    out = _correlate_port(fixed)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    _assert_states_agree(out[:, :, 2] == 1, ref[:, :, 2] == 1, out[:, :, :2], ref[:, :, :2])


def test_coarse_overreach_escalates_like_jax():
    """A fixed window of 8 on the golden scene's 3-level pyramid is
    overrun at a coarse level (reach 14): both packages rerun the pyramid
    with data-driven windows and agree to the sweep's bounds."""
    img1, img2, _ = golden_scene()
    kw = dict(scale_min_size=16, corridor_window_fixed=8)
    ref = jc.correlate_images(
        _Src(img1), _Src(img2), F_HSHIFT, JProjectionMode.AFFINE, JCorrelationConfig(**kw)
    )
    assert jc._LAST_PLAN.get("escalated_from_fixed") == 8
    out = tc.correlate_images(
        _Src(img1), _Src(img2), F_HSHIFT, ProjectionMode.AFFINE,
        CorrelationConfig(**kw), device="cpu",
    )
    _assert_states_agree(out[:, :, 2] == 1, ref[:, :, 2] == 1, out[:, :, :2], ref[:, :, :2])
