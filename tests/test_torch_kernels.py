"""The kernel wrappers of the PyTorch/CUDA port.

On the CPU: each wrapper checks its inputs, raises on what its kernel
does not take, and runs the plain version without counting a launch;
the launch geometry the wrappers compute (K1's tile plans, K2's split
plan) covers its plane or table exactly and fits the card's shared
memory — K1's at every window, in chunks of offsets beyond 164 ("horiz")
or 150 ("vert"), and for the per-pixel form beyond its budget; the
per-pixel plain version equals the static one on a uniform axis; the
threefry draws (utils.prng) hold their shape and range. With a card
(tests marked `cuda`, skipped without one): each kernel against its
plain version on the card, with the tolerances of chip_smoke.py — K1's
static forms under 0.5 % of valid flags differ, corr within 1e-4, over
99.5 % of positions equal, its per-pixel form bit for bit; K2 counts
equal and sums within rtol 1e-5; K3 exact — also at shapes that are no
multiple of a tile, at the window buckets' ends (8, 128), and for K2 at
C 50,001 with holes in the mask or none set; K1's static forms bit-equal
to the plain version at windows 192 and 256 (two chunks), and its
row-halo form at 192. K1's per-pixel form bit-equal off the tile grid,
at windows 8, 128 and 192, on a checkerboard of axes finer than a tile,
and equal to the static kernel on a uniform axis. K1's row-halo form
(K1s, shards on one card, one of odd height) is held to its sharded
plain version (the per-pixel form bit for bit, the static ones with
K1's tolerances) and to the unsharded kernel exactly; K3 launches on
the caller's current stream; the draws on the card equal the CPU's, the
--max-points sample and the exact cross-check too, and the depth
colouring is within 1 level of it; with a second card, every kernel
launches on cuda:1. Every pyramid level over four row shards on one
card equals the unsharded level bit for bit, at the 1024x1024 SEM pair
and at the diagonal perspective pair (K1s's per-pixel form). At the
perspective path's shapes: K1's per-pixel
form at corridor size 4, K2 at 150,000 candidates from the 7-point
solver, K3 at (13, 7, 50,000) draws. This file imports nothing of JAX,
so the card tests run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cybervision_tpu_torch.ops import correlation as corr
from cybervision_tpu_torch.ops import gather as k3
from cybervision_tpu_torch.ops import ncc_sweep as k1
from cybervision_tpu_torch.ops import score as k2
from cybervision_tpu_torch.ops.epipolar import pack_coord_table, solve_affine_batch
from cybervision_tpu_torch.parallel import Mesh, gather_rows
from cybervision_tpu_torch.utils import prng

torch.set_num_threads(2)

F_HSHIFT = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)
SWEEP_KW = dict(threshold=0.6, min_stdev=1.0, window=8, corridor_size=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda1():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def _sweep_fields(device, h=72, w=64, dx=3, axis="horiz", corridor_size=2):
    """The refine prologue's kernel inputs on a textured shift scene;
    "vert" transposes every field (a vertical-corridor problem)."""
    if axis == "vert":
        fields, kw = _sweep_fields(device, w, h, dx, "horiz", corridor_size)
        return {k: v.transpose(-2, -1).contiguous() for k, v in fields.items()}, dict(kw, h2=h, w2=w)
    rng = np.random.RandomState(4)
    base = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w + dx)), 1.5)
    base = np.round((base - base.min()) / np.ptp(base) * 255).astype(np.uint8)
    img1, img2 = base[:, :w].copy(), base[:, dx : dx + w].copy()
    qy, qx = np.mgrid[0 : h // 2, 0 : w // 2]
    pos = np.stack([np.maximum(2 * qx - dx, 0), 2 * qy], axis=-1).astype(np.int32)
    prev = corr.CorrelationState(
        pos=torch.as_tensor(pos, device=device),
        corr=torch.ones(pos.shape[:2], device=device),
        valid=torch.ones(pos.shape[:2], dtype=torch.bool, device=device),
    )
    wtr, tmin = corr.split_trange(corr.warp_shift_range(F_HSHIFT, 1.0, h, w, h, w))
    fields = corr.sweep_inputs(
        torch.as_tensor(img1, device=device), torch.as_tensor(img2, device=device),
        prev, torch.as_tensor(F_HSHIFT, dtype=torch.float32, device=device),
        1.0, 1.0, 2.5, 1.0, corridor_size, wtr if axis else None, tmin if axis else 0, axis,
    )
    return fields, dict(SWEEP_KW, corridor_size=corridor_size, h2=h, w2=w)


def _ransac_inputs(device, m=3000, c=2000):
    rng = np.random.RandomState(6)
    x1, y1 = rng.randint(0, 512, m), rng.randint(0, 512, m)
    x2 = np.clip(x1 - rng.randint(2, 9, m), 0, None)
    table = np.stack([x1, y1, x2, y1], axis=1).astype(np.int64)
    mb = 8192
    mpad = np.zeros((mb, 4), np.int64)
    mpad[:m] = table
    p1 = torch.as_tensor(mpad[:, 0:2], dtype=torch.float32, device=device)
    p2 = torch.as_tensor(mpad[:, 2:4], dtype=torch.float32, device=device)
    valid = torch.as_tensor(np.arange(mb) < m, device=device)
    idx = torch.as_tensor(rng.randint(0, m, (c, 4)), device=device)
    ff, _ = solve_affine_batch(p1[idx], p2[idx], 1e-3)
    return ff.contiguous(), p1, p2, valid, torch.as_tensor(pack_coord_table(mpad), device=device)


# --- the wrappers on the CPU -------------------------------------------------


def test_sweep_wrapper_runs_plain_on_cpu_without_counting():
    fields, kw = _sweep_fields("cpu")
    k1.launches = 0
    out = k1.ncc_sweep(*fields.values(), axis="horiz", **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis="horiz", **kw)
    assert k1.launches == 0
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(out[0]).float().mean() > 0.3


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda f, kw: f.update(avg1=f["avg1"].double()), TypeError),
        (lambda f, kw: f.update(start=f["start"][:-1]), ValueError),
        (lambda f, kw: f.update(w0=f["w0"][:3]), ValueError),
        (lambda f, kw: f.update(add=f["add"].t().contiguous().t()), ValueError),
        (lambda f, kw: kw.update(window=4), ValueError),
        (lambda f, kw: kw.update(axis="diagonal"), ValueError),
    ],
)
def test_sweep_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    fields, kw = _sweep_fields("cpu", h=40, w=32)
    kw["axis"] = "horiz"
    change(fields, kw)
    with pytest.raises(error):
        k1.ncc_sweep(*fields.values(), **kw)


def test_score_wrapper_checks_and_runs_plain_on_cpu():
    ff, p1, p2, valid, _ = _ransac_inputs("cpu", c=300)
    k2.launches = 0
    count, esum = k2.score_candidates(ff, p1, p2, valid, 0.1)
    assert k2.launches == 0 and count.dtype == torch.int32 and esum.dtype == torch.float32
    assert int(count.max()) > 2000
    with pytest.raises(TypeError):
        k2.score_candidates(ff.double(), p1, p2, valid, 0.1)
    with pytest.raises(ValueError):
        k2.score_candidates(ff, p1, p2[:-1], valid, 0.1)
    with pytest.raises(ValueError):
        k2.score_candidates(ff, p1, p2, valid.int(), 0.1)


def test_gather_wrapper_checks_and_runs_plain_on_cpu():
    *_, packed = _ransac_inputs("cpu")
    idx = torch.randint(0, 3000, (13, 4, 500), dtype=torch.int32)
    k3.launches = 0
    out = k3.gather_packed(packed, idx)
    assert k3.launches == 0 and out.shape == (2, 13, 4, 500)
    torch.testing.assert_close(out[1], packed[1][idx.long()], rtol=0, atol=0)
    with pytest.raises(TypeError):
        k3.gather_packed(packed.long(), idx)
    with pytest.raises(ValueError):
        k3.gather_packed(packed[:1], idx)


@pytest.mark.parametrize("axis", ["horiz", "vert"])
@pytest.mark.parametrize("h,w", [(1024, 1024), (999, 777), (300, 280), (17, 5), (1, 1)])
def test_sweep_tile_plan_covers_the_plane(axis, h, w):
    plan = k1.sweep_tile_plan(h, w, 16, axis)
    (th, tw), (gx, gy) = plan["tile"], plan["grid"]
    assert th * tw == 4 * plan["threads"]
    # Every pixel in exactly one tile; no tile wholly outside the plane.
    assert gx * tw >= w > (gx - 1) * tw
    assert gy * th >= h > (gy - 1) * th
    # Short along the sweep axis, where the staged band grows.
    assert (tw if axis == "horiz" else th) > (th if axis == "horiz" else tw)


@pytest.mark.parametrize("axis", ["horiz", "vert"])
@pytest.mark.parametrize("window", [8, 16, 24, 32, 64, 128])
def test_sweep_tile_plan_fits_every_window_bucket(axis, window):
    """corridor_window_buckets, the low-memory 8 and the fixed 16: every
    window the CLI sweeps fits one block's 227 KB as one chunk of all its
    2 * window + 1 offsets, and the bytes grow with the band."""
    plan = k1.sweep_tile_plan(64, 64, window, axis)
    assert plan["smem_bytes"] <= 232_448
    assert plan["chunks"] == ((-window, window),) and plan["chunk"] == 2 * window + 1
    assert plan["smem_bytes"] > k1.sweep_tile_plan(64, 64, window - 1, axis)["smem_bytes"]


def _assert_chunks_cover(chunks, window):
    """Chunks in increasing order, covering [-window, window] with no
    gap and no overlap."""
    assert chunks[0][0] == -window and chunks[-1][1] == window
    assert all(lo <= hi for lo, hi in chunks)
    assert all(a[1] + 1 == b[0] for a, b in zip(chunks, chunks[1:]))


@pytest.mark.parametrize("axis", ["horiz", "vert", None])
@pytest.mark.parametrize("window", [192, 256, 512, 1024])
def test_sweep_tile_plan_chunks_every_wide_window(axis, window):
    """Windows whose whole band does not fit one block (the API's
    corridor_window_fixed or buckets beyond the CLI's 128) sweep in
    chunks of offsets that do, all of one length but the last."""
    limit = k1.PIXEL_SMEM_LIMIT if axis is None else k1.SMEM_LIMIT
    plan = k1.sweep_tile_plan(1024, 1024, window, axis)
    chunks = plan["chunks"]
    assert plan["smem_bytes"] <= min(limit, 232_448) and len(chunks) > 1
    _assert_chunks_cover(chunks, window)
    assert {hi - lo + 1 for lo, hi in chunks[:-1]} == {plan["chunk"]}
    assert chunks[-1][1] - chunks[-1][0] + 1 <= plan["chunk"]
    # The fewest chunks that fit: one fewer would not.
    n_off = 2 * window + 1
    assert k1._tile_smem(axis, -(-n_off // (len(chunks) - 1)) - 1) > limit


@pytest.mark.parametrize("axis", ["horiz", "vert"])
def test_sweep_tile_plan_raises_where_the_band_cannot_fit(axis):
    """Every form has a tile plan at any window (256 was refused before
    the band was chunked); only an axis the kernel does not know is
    refused."""
    plan = k1.sweep_tile_plan(1024, 1024, 256, axis)
    assert plan["smem_bytes"] <= 232_448
    _assert_chunks_cover(plan["chunks"], 256)
    with pytest.raises(ValueError):
        k1.sweep_tile_plan(1024, 1024, 16, "diagonal")


@pytest.mark.parametrize("h,w", [(1024, 1024), (999, 777), (300, 280), (17, 5), (1, 1)])
def test_pixel_tile_plan_covers_the_plane(h, w):
    """The per-pixel form's tiles: square (its bands grow along both
    axes), four pixels a thread, every pixel in exactly one tile."""
    plan = k1.sweep_tile_plan(h, w, 32, None)
    (th, tw), (gx, gy) = plan["tile"], plan["grid"]
    assert th == tw and th * tw == 4 * plan["threads"]
    assert gx * tw >= w > (gx - 1) * tw
    assert gy * th >= h > (gy - 1) * th


@pytest.mark.parametrize("window", [8, 16, 24, 32, 64, 128])
def test_pixel_tile_plan_fits_the_window_buckets_it_can(window):
    """A window whose two bands of 2 * window + 1 offsets fit the
    per-pixel form's budget sweeps as one chunk, and its bytes grow with
    the band; a wider one in the fewest chunks that fit."""
    plan = k1.sweep_tile_plan(64, 64, window, None)
    n_off = 2 * window + 1
    assert plan["smem_bytes"] <= min(k1.PIXEL_SMEM_LIMIT, 232_448)
    _assert_chunks_cover(plan["chunks"], window)
    if k1._tile_smem(None, n_off - 1) <= k1.PIXEL_SMEM_LIMIT:
        assert plan["chunks"] == ((-window, window),) and plan["chunk"] == n_off
        assert plan["smem_bytes"] > k1.sweep_tile_plan(64, 64, window - 1, None)["smem_bytes"]
    else:
        n = len(plan["chunks"])
        assert n > 1 and k1._tile_smem(None, -(-n_off // (n - 1)) - 1) > k1.PIXEL_SMEM_LIMIT


@pytest.mark.parametrize("axis", ["horiz", "vert"])
def test_per_pixel_plain_equals_the_static_form_on_a_uniform_axis(axis):
    """With every pixel on one axis, the per-pixel form's plain version
    is the static form's, bit for bit: the warp of each window element
    and the hypothesis of each pixel follow that one axis."""
    fields, kw = _sweep_fields("cpu", axis=axis)
    fields["vert"] = torch.full_like(fields["vert"], float(axis == "vert"))
    out = k1.ncc_sweep_plain(*fields.values(), axis=None, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    assert torch.isfinite(ref[0]).float().mean() > 0.3
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 13_066), (-7, 9), (5, 5)])
def test_randint_draws_are_int32_in_range(lo, hi):
    out = prng.randint(prng.prng_key(3), (13, 4, 257), lo, hi)
    assert out.dtype == torch.int32 and out.shape == (13, 4, 257)
    assert int(out.min()) >= lo and int(out.max()) <= max(lo, hi - 1)
    if hi - lo > 8:
        assert len(torch.unique(out)) > min(hi - lo, 1000) // 2


@pytest.mark.parametrize("c,m", [
    (50_000, 32_768), (50_001, 8192), (12_500, 32_768), (2000, 3000),
    (1, 1), (7, 511), (7, 512), (7, 513), (100, 0),
])
def test_score_plan_splits_cover_the_matches(c, m):
    plan = k2.score_plan(c, m)
    per_block, split, n = plan["cands_per_block"], plan["split"], plan["n_splits"]
    assert per_block == plan["threads"] * k2.CANDS_PER_THREAD
    assert plan["cand_tiles"] * per_block >= c > (plan["cand_tiles"] - 1) * per_block
    # One shared-memory slab per split; splits cover [0, M), none empty.
    assert split == k2.SLAB
    bounds = [(i * split, min(m, (i + 1) * split)) for i in range(n)]
    assert all(hi > lo for lo, hi in bounds)
    assert sum(hi - lo for lo, hi in bounds) == m


# --- the kernels on the card --------------------------------------------------


def _mixed_axes(fields, kind, block=16):
    """The fields with the per-pixel axis set on a checkerboard of
    `block`-pixel squares, or across the diagonal (a "vert" triangle)."""
    h, w = fields["avg1"].shape
    yy, xx = np.mgrid[0:h, 0:w]
    vert = (yy // block + xx // block) % 2 if kind == "checker" else xx * h > yy * w
    return dict(fields, vert=torch.as_tensor(vert.astype(np.float32), device=fields["avg1"].device))


def _assert_equal_sweeps(out, ref):
    assert torch.isfinite(ref[0]).float().mean() > 0.2
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _sweeps_agree(out, ref):
    vk, vp = torch.isfinite(out[0]), torch.isfinite(ref[0])
    assert (vk != vp).float().mean() < 0.005
    both = vk & vp
    assert both.float().mean() > 0.2
    assert (out[0] - ref[0])[both].abs().max() <= 1e-4
    same = (out[1] == ref[1]) & (out[2] == ref[2])
    assert same[both].float().mean() > 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", None])
def test_sweep_kernel_matches_plain(cuda, axis):
    fields, kw = _sweep_fields(cuda, axis=axis)
    k1.launches = 0
    out = k1.ncc_sweep(*fields.values(), axis=axis, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    torch.cuda.synchronize()
    assert k1.launches == 1
    if axis is None:
        _assert_equal_sweeps(out, ref)
    else:
        _sweeps_agree(out, ref)


@pytest.mark.cuda
def test_sweep_kernel_reads_zero_outside_the_plane(cuda):
    """p_ok set inside the 11x11 margin: the kernel's bounded path must
    treat out-of-plane values as zero, like the plain version's padding."""
    fields, kw = _sweep_fields(cuda, axis="horiz")
    fields["p_ok"] = torch.ones_like(fields["p_ok"])
    out = k1.ncc_sweep(*fields.values(), axis="horiz", **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis="horiz", **kw)
    _sweeps_agree(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", "vert"])
def test_sweep_kernel_matches_plain_off_the_tile_grid(cuda, axis):
    """999x777: no multiple of either tile shape, so the last row and
    column of tiles are ragged."""
    h, w = (999, 777) if axis == "horiz" else (777, 999)
    fields, kw = _sweep_fields(cuda, h=h, w=w, axis=axis)
    out = k1.ncc_sweep(*fields.values(), axis=axis, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    _sweeps_agree(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", "vert"])
@pytest.mark.parametrize("window", [8, 128])
def test_sweep_kernel_matches_plain_at_the_window_ends(cuda, axis, window):
    h, w = (300, 280) if axis == "horiz" else (280, 300)
    fields, kw = _sweep_fields(cuda, h=h, w=w, axis=axis)
    kw = dict(kw, window=window)
    out = k1.ncc_sweep(*fields.values(), axis=axis, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    _sweeps_agree(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", "vert"])
@pytest.mark.parametrize("window", [192, 256])
def test_sweep_kernel_equals_plain_at_wide_windows(cuda, axis, window):
    """Two chunks of offsets per stripe: bit-equal to the plain version,
    as the one-chunk windows are."""
    h, w = (300, 280) if axis == "horiz" else (280, 300)
    fields, kw = _sweep_fields(cuda, h=h, w=w, axis=axis)
    kw = dict(kw, window=window)
    assert len(k1.sweep_tile_plan(h, w, window, axis)["chunks"]) == 2
    out = k1.ncc_sweep(*fields.values(), axis=axis, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    assert torch.isfinite(ref[0]).float().mean() > 0.2
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", "vert"])
def test_row_halo_sweep_equals_plain_at_window_192(cuda, axis):
    """Two 200-row shards (a halo is KS + 192 = 197 rows) of a 400-row
    plane on one card: the chunked row-halo kernel equals the unsharded
    plain version bit for bit."""
    fields, kw = _sweep_fields(cuda, h=400, w=64, axis=axis)
    kw = dict(kw, window=192)
    out = [gather_rows(o, cuda) for o in k1.ncc_sweep_sharded(
        Mesh((cuda,) * 2), *fields.values(), axis=axis, **kw)]
    ref = k1.ncc_sweep_plain(*fields.values(), axis=axis, **kw)
    assert torch.isfinite(ref[0]).float().mean() > 0.2
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["holes", "none"])
def test_score_kernel_matches_plain_at_awkward_shapes(cuda, mask):
    """C 50,001 (a ragged candidate tile) against a table whose mask has
    holes in the middle, or no valid row at all (counts and sums 0)."""
    ff, p1, p2, valid, _ = _ransac_inputs(cuda, c=50_001)
    if mask == "holes":
        valid[100:700] = False
        valid[1500:1530] = False
    else:
        valid[:] = False
    count, esum = k2.score_candidates(ff, p1, p2, valid, 0.1)
    c_ref, s_ref = k2.score_candidates_plain(ff, p1, p2, valid, 0.1)
    assert torch.equal(count, c_ref)
    torch.testing.assert_close(esum, s_ref, rtol=1e-5, atol=0)
    if mask == "none":
        assert int(count.abs().sum()) == 0 and float(esum.abs().sum()) == 0.0
    else:
        assert int(count.max()) > 2000


@pytest.mark.cuda
def test_score_kernel_matches_plain(cuda):
    ff, p1, p2, valid, _ = _ransac_inputs(cuda)
    k2.launches = 0
    count, esum = k2.score_candidates(ff, p1, p2, valid, 0.1)
    c_ref, s_ref = k2.score_candidates_plain(ff, p1, p2, valid, 0.1)
    assert k2.launches == 1
    assert torch.equal(count, c_ref)
    torch.testing.assert_close(esum, s_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8192, 32768])
def test_gather_kernel_matches_take(cuda, m):
    """The smallest bucket's table (cached in L1) and the main path's
    (through L2)."""
    packed = torch.randint(0, 2**31 - 1, (2, m), dtype=torch.int32, device=cuda)
    idx = torch.randint(0, m, (13, 4, 5000), dtype=torch.int32, device=cuda)
    k3.launches = 0
    out = k3.gather_packed(packed, idx)
    assert k3.launches == 1
    assert torch.equal(out, k3.gather_packed_plain(packed, idx))


@pytest.mark.cuda
def test_gather_kernel_launches_on_the_current_stream(cuda):
    """Under a torch.cuda.stream context the kernel runs on that stream:
    its output is complete once the stream is synchronised."""
    packed = torch.randint(0, 2**31 - 1, (2, 32768), dtype=torch.int32, device=cuda)
    idx = torch.randint(0, 32768, (13, 4, 50_000), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        out = k3.gather_packed(packed, idx)
    side.synchronize()
    assert torch.equal(out, k3.gather_packed_plain(packed, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,shape,top", [(0, (13, 4, 50_000), 13_066), (2**40 + 7, (13, 7, 33), 1000)])
def test_randint_on_the_card_equals_the_cpu(cuda, seed, shape, top):
    key = prng.prng_key(seed)
    out = prng.randint(key, shape, 0, top, device=cuda)
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), prng.randint(key, shape, 0, top))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [500, 5000])
def test_word_sample_on_the_card_equals_the_cpu(cuda, k):
    """The --max-points draw (float64 uniform, stable sort) on the card:
    the CPU's indices and words, below and above the valid count."""
    g = torch.Generator().manual_seed(4)
    word = torch.where(torch.rand((60, 70), generator=g) < 0.8, 1 << 24, 0).to(torch.int32)
    word |= torch.randint(0, 4096, (60, 70), generator=g, dtype=torch.int32)
    u = prng.uniform(prng.prng_key(3), (60 * 70,), cuda)
    assert u.device.type == "cuda" and torch.equal(u.cpu(), prng.uniform(prng.prng_key(3), (60 * 70,)))
    idx_c, words_c = corr.sample_word_grid(word.to(cuda), k, 3)
    idx_h, words_h = corr.sample_word_grid(word, k, 3)
    np.testing.assert_array_equal(idx_c, idx_h)
    np.testing.assert_array_equal(words_c, words_h)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_cross_check_exact_on_the_card_equals_the_cpu(cuda, scale):
    rng = np.random.RandomState(6)
    h, w, inv_s = 40, 48, int(round(1 / scale))
    states = []
    for spread in (6 * inv_s, None):
        ys, xs = np.mgrid[0:h, 0:w]
        if spread is None:
            pos = np.stack([rng.randint(0, w * inv_s, (h, w)), rng.randint(0, h * inv_s, (h, w))], -1)
        else:
            pos = np.clip(np.stack([xs * inv_s, ys * inv_s], -1)
                          + rng.randint(-spread, spread + 1, (h, w, 2)), 0, None)
        states.append(corr.CorrelationState(
            torch.as_tensor(pos.astype(np.int32)),
            torch.as_tensor(rng.uniform(0.6, 1, (h, w)).astype(np.float32)),
            torch.as_tensor(rng.uniform(size=(h, w)) < 0.5),
        ))
    ref = corr.cross_check_exact(*states, scale)
    out = corr.cross_check_exact(*(corr.CorrelationState(*(t.to(cuda) for t in st)) for st in states), scale)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_depth_colouring_on_the_card_matches_the_cpu(cuda):
    """The PNG fast lane's colouring on the card: alpha equal, RGB within
    1 level (the card's hypotf may differ from the CPU's by an ulp)."""
    from cybervision_tpu_torch.output.writers import _affine_depth_rgba

    rng = np.random.RandomState(7)
    h, w = 200, 240
    ys, xs = np.mgrid[0:h, 0:w]
    arr = np.stack([np.clip(xs - rng.randint(0, 30, (h, w)), 0, w - 1),
                    np.clip(ys + rng.randint(-5, 6, (h, w)), 0, h - 1),
                    rng.uniform(size=(h, w)) < 0.7], -1).astype(np.int32)
    ref = _affine_depth_rgba(torch.as_tensor(arr), -1.0).numpy()
    out = _affine_depth_rgba(torch.as_tensor(arr, device=cuda), -1.0).cpu().numpy()
    np.testing.assert_array_equal(out[:, :, 3], ref[:, :, 3])
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda):
    ff, p1, p2, valid, packed = _ransac_inputs(cuda, c=100)
    with pytest.raises(ValueError):
        k2.score_candidates(ff, p1.cpu(), p2, valid, 0.1)
    with pytest.raises(TypeError):
        k3.gather_packed(packed, torch.zeros(5, dtype=torch.int64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("axis,h", [("vert", 72), ("horiz", 72), (None, 72), ("vert", 77), ("horiz", 77), (None, 77)])
def test_row_halo_sweep_matches_plain_and_equals_unsharded(cuda, axis, h):
    """Four shards on one card: the row-halo kernel against its plain
    version (the per-pixel form, on a checkerboard of axes, bit for bit),
    and the gathered result against the unsharded kernel. At 77 rows the
    shards are 20, 20, 20 and 17 rows: the last of odd height."""
    fields, kw = _sweep_fields(cuda, h=h, axis=axis)
    if axis is None:
        fields = _mixed_axes(fields, "checker", block=12)
    mesh = Mesh((cuda,) * 4)
    k1.launches = k1.sharded_launches = 0
    out = [gather_rows(o, cuda) for o in k1.ncc_sweep_sharded(mesh, *fields.values(), axis=axis, **kw)]
    torch.cuda.synchronize()
    assert (k1.launches, k1.sharded_launches) == (4, 1)
    ref = [gather_rows(o, cuda) for o in k1.ncc_sweep_sharded(
        mesh, *fields.values(), axis=axis, plain=True, **kw)]
    assert (k1.launches, k1.sharded_launches) == (4, 1)
    if axis is None:
        _assert_equal_sweeps(out, ref)
    else:
        _sweeps_agree(out, ref)
    single = k1.ncc_sweep(*fields.values(), axis=axis, **kw)
    for a, b in zip(out, single):
        assert torch.equal(a, b)


def _levels_on_the_card(cuda, img1, img2, f, proj, n=4):
    """The pyramid of an image pair run unsharded on the card, every level
    also run over n shards on the card from the same previous states:
    [(level, unsharded states, sharded states)], the finest level's
    windows from its reach, as correlate_images picks them."""
    from cybervision_tpu_torch.config import CorrelationConfig, pyramid_scales

    cc = CorrelationConfig()
    params = (cc.threshold(proj), cc.min_stdev(proj), cc.corridor_min_range(proj),
              cc.corridor_extend_range(proj), cc.corridor_size(proj))
    f = corr.normalize_f(f)
    pair = corr._Pair((cuda,), img1, img2, f)
    levels = [corr._plan_level(f, s, img1.shape, img2.shape)
              for s in pyramid_scales(img1.shape[::-1], cc.scale_min_size)]
    mesh = Mesh((cuda,) * n)
    corr._LAST_PLAN = {"mesh": True, "sharded_levels": [], "sharded_prologue": [], "windows": []}
    prev, out = (None, None), []
    for i, lv in enumerate(levels):
        wins = (16, 16)
        if i == len(levels) - 1:
            wins = tuple(max(16, corr._bucket(r, cc))
                         for r in corr._reach_pair(pair, *prev, lv, params, None))
        single = corr._level_step(pair, *prev, lv, params, *wins, i == 0)
        sharded = corr._level_step(pair, *prev, lv, params, *wins, i == 0, mesh)
        out.append((lv, single, sharded))
        prev = single
    torch.cuda.synchronize()
    return out, corr._LAST_PLAN


def _assert_levels_equal(levels, cuda):
    for _, single, sharded in levels:
        for a, b in zip(single, sharded):
            for x, y in zip(corr.gather_state(a, cuda), corr.gather_state(b, cuda)):
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_sharded_levels_on_the_card_equal_unsharded_at_1024_sem(cuda):
    """The 1024x1024 SEM pair (chip_smoke.synth_sem_pair, horizontal
    disparity): every pyramid level over four shards on one card equals
    the unsharded level bit for bit, resize to cross-check, its finest
    refine level's sweeps as K1s."""
    import chip_smoke
    from cybervision_tpu_torch.config import ProjectionMode

    img1, img2, _ = chip_smoke.synth_sem_pair(1024, 1024)
    levels, plan = _levels_on_the_card(cuda, img1, img2, F_HSHIFT, ProjectionMode.AFFINE)
    # Each level ran twice (unsharded, sharded): the plan's odd entries.
    assert all(plan["sharded_prologue"][1::2]) and plan["sharded_levels"][-1], plan
    _assert_levels_equal(levels, cuda)
    assert float(corr.gather_state(levels[-1][1][0], cuda).valid.float().mean()) > 0.5


@pytest.mark.cuda
def test_sharded_levels_on_the_card_equal_unsharded_at_the_diagonal_pair(cuda):
    """chip_smoke's diagonal pair at 1024x819 with the F of its cameras:
    no level has a uniform sweep axis, so the refine levels' K1s runs
    its per-pixel form on four shards on one card; every level equals
    the unsharded one bit for bit."""
    import chip_smoke
    from cybervision_tpu_torch.config import ProjectionMode

    w = round(chip_smoke.PERSP_W * chip_smoke.FULL_SCALE)
    h = round(chip_smoke.PERSP_H * chip_smoke.FULL_SCALE)
    views, _, k, cams = chip_smoke.render_perspective(w, h, (chip_smoke.PERSP_CAM_DIAGONAL,))
    r, t = cams[0].r_matrix, cams[0].t
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    k_inv = np.linalg.inv(k)
    f = k_inv.T @ tx @ r @ k_inv
    k1.pixel_launches = k1.sharded_launches = 0
    levels, plan = _levels_on_the_card(cuda, views[0], views[1], f, ProjectionMode.PERSPECTIVE)
    assert all(lv.fv_f is None and lv.fv_r is None for lv, _, _ in levels[1:])
    sharded = sum(plan["sharded_levels"][1::2])
    assert sharded and k1.sharded_launches == 2 * sharded
    assert k1.pixel_launches >= 4 * k1.sharded_launches
    _assert_levels_equal(levels, cuda)
    # Not an empty scene: its finest level keeps 0.236 of its pixels on
    # an H100.
    assert float(corr.gather_state(levels[-1][1][0], cuda).valid.float().mean()) > 0.2


@pytest.mark.cuda
def test_kernels_launch_on_the_second_card(cuda1):
    """Each wrapper launches on its tensors' device, not the current one."""
    assert torch.cuda.current_device() == 0
    fields, kw = _sweep_fields(cuda1)
    out = k1.ncc_sweep(*fields.values(), axis="horiz", **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis="horiz", **kw)
    torch.cuda.synchronize(cuda1)
    assert out[0].device == cuda1
    _sweeps_agree(out, ref)
    ff, p1, p2, valid, packed = _ransac_inputs(cuda1)
    count, esum = k2.score_candidates(ff, p1, p2, valid, 0.1)
    c_ref, s_ref = k2.score_candidates_plain(ff, p1, p2, valid, 0.1)
    assert torch.equal(count, c_ref)
    torch.testing.assert_close(esum, s_ref, rtol=1e-5, atol=0)
    idx = torch.randint(0, 3000, (13, 4, 5000), dtype=torch.int32, device=cuda1)
    assert torch.equal(k3.gather_packed(packed, idx), k3.gather_packed_plain(packed, idx))
    torch.cuda.synchronize(cuda1)


# --- the perspective path's shapes -----------------------------------------


def _perspective_table(device, m=3000):
    """(mpad (8192, 4), p1, p2, valid, packed, t1, t2) of a two-camera
    scene: integral matches of a random 3D cloud, 10 % outliers."""
    from cybervision_tpu_torch.ops.epipolar import _hartley_np

    rng = np.random.RandomState(8)
    k = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    th = 0.25
    r = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    pts = np.stack([rng.uniform(-3, 3, m), rng.uniform(-3, 3, m), rng.uniform(6, 14, m)], axis=1)
    q1 = pts @ k.T
    q2 = (pts @ r.T + np.array([1.0, 0.1, 0.2])) @ k.T
    table = np.round(np.concatenate([q1[:, :2] / q1[:, 2:], q2[:, :2] / q2[:, 2:]], axis=1))
    bad = rng.rand(m) < 0.1
    table[bad] = rng.uniform(0, 480, (bad.sum(), 4)).round()
    table = np.clip(table, 0, 32767).astype(np.int64)
    mb = 8192
    mpad = np.zeros((mb, 4), np.int64)
    mpad[:m] = table
    f32 = dict(dtype=torch.float32, device=device)
    return (
        mpad,
        torch.as_tensor(mpad[:, 0:2], **f32),
        torch.as_tensor(mpad[:, 2:4], **f32),
        torch.as_tensor(np.arange(mb) < m, device=device),
        torch.as_tensor(pack_coord_table(mpad), device=device),
        torch.as_tensor(_hartley_np(table[:, 0:2]), **f32),
        torch.as_tensor(_hartley_np(table[:, 2:4]), **f32),
    )


@pytest.mark.cuda
def test_per_pixel_sweep_matches_plain_at_corridor_4(cuda):
    """K1's per-pixel form at the perspective corridor (9 stripes) and
    threshold 0.5, the axis chosen per pixel on a checkerboard."""
    fields, kw = _sweep_fields(cuda, h=96, w=80, axis=None, corridor_size=4)
    yy, xx = np.mgrid[0:96, 0:80]
    fields["vert"] = torch.as_tensor(((yy // 16 + xx // 16) % 2).astype(np.float32), device=cuda)
    kw = dict(kw, threshold=0.5)
    k1.launches = k1.pixel_launches = 0
    out = k1.ncc_sweep(*fields.values(), axis=None, **kw)
    ref = k1.ncc_sweep_plain(*fields.values(), axis=None, **kw)
    torch.cuda.synchronize()
    assert k1.launches == k1.pixel_launches == 1
    _assert_equal_sweeps(out, ref)


@pytest.mark.cuda
def test_per_pixel_sweep_equals_plain_off_the_tile_grid(cuda):
    """999x777 (no multiple of the 32x32 tile) with the axis flipping
    across the diagonal: ragged tiles, and tiles that stage both bands."""
    fields, kw = _sweep_fields(cuda, h=999, w=777, axis=None)
    fields = _mixed_axes(fields, "diagonal")
    out = k1.ncc_sweep(*fields.values(), axis=None, **kw)
    _assert_equal_sweeps(out, k1.ncc_sweep_plain(*fields.values(), axis=None, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 128, 192])
def test_per_pixel_sweep_equals_plain_at_the_window_ends(cuda, window):
    """The window buckets' ends and 192, whose offsets the per-pixel
    form cuts into several chunks per tile."""
    fields, kw = _sweep_fields(cuda, h=300, w=280, axis=None)
    fields = _mixed_axes(fields, "diagonal")
    kw = dict(kw, window=window)
    if window >= 128:
        assert len(k1.sweep_tile_plan(300, 280, window, None)["chunks"]) > 1
    out = k1.ncc_sweep(*fields.values(), axis=None, **kw)
    _assert_equal_sweeps(out, k1.ncc_sweep_plain(*fields.values(), axis=None, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["horiz", "vert"])
def test_per_pixel_sweep_equals_the_static_kernel_on_a_uniform_axis(cuda, axis):
    """Every pixel on one axis: the per-pixel kernel equals the static
    kernel of that axis bit for bit."""
    fields, kw = _sweep_fields(cuda, h=300, w=280, axis=axis)
    fields["vert"] = torch.full_like(fields["vert"], float(axis == "vert"))
    out = k1.ncc_sweep(*fields.values(), axis=None, **kw)
    _assert_equal_sweeps(out, k1.ncc_sweep(*fields.values(), axis=axis, **kw))


@pytest.mark.cuda
def test_per_pixel_sweep_equals_plain_on_a_fine_checkerboard(cuda):
    """Squares of 5 pixels, smaller than a tile: every tile mixes both
    axes among its pixels and its elements."""
    fields, kw = _sweep_fields(cuda, h=96, w=80, axis=None, corridor_size=4)
    fields = _mixed_axes(fields, "checker", block=5)
    out = k1.ncc_sweep(*fields.values(), axis=None, **kw)
    _assert_equal_sweeps(out, k1.ncc_sweep_plain(*fields.values(), axis=None, **kw))


@pytest.mark.cuda
def test_score_kernel_matches_plain_at_150k_perspective_candidates(cuda):
    """K2 at C = 150,000: 50,000 7-point samples solved as the
    perspective round solves them, three roots each, F_px = T2^T F' T1."""
    from cybervision_tpu_torch.ops.epipolar import solve_perspective_batch

    _, p1, p2, valid, _, t1, t2 = _perspective_table(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    idx = torch.randint(0, 3000, (50_000, 7), generator=gen, device=cuda)
    n1 = torch.einsum("ij,bnj->bni", t1[:2, :2], p1[idx]) + t1[:2, 2]
    n2 = torch.einsum("ij,bnj->bni", t2[:2, :2], p2[idx]) + t2[:2, 2]
    f, ok = solve_perspective_batch(n1, n2, 1e-3)
    ff = torch.einsum("ji,brjk,kl->bril", t2, f, t1).reshape(-1, 3, 3).contiguous()
    assert ff.shape[0] == 150_000 and int(ok.sum()) > 10_000
    k2.launches = 0
    count, esum = k2.score_candidates(ff, p1, p2, valid, 6.4)
    c_ref, s_ref = k2.score_candidates_plain(ff, p1, p2, valid, 6.4)
    assert k2.launches == 1
    assert torch.equal(count, c_ref)
    assert int(count.max()) > 2000
    torch.testing.assert_close(esum, s_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_gather_kernel_matches_take_at_seven_samples(cuda):
    """K3 at the perspective round's (13, 7, 50,000) draws."""
    _, _, _, _, packed, _, _ = _perspective_table(cuda)
    idx = prng.randint(prng.prng_key(3), (13, 7, 50_000), 0, 3000, device=cuda)
    k3.launches = 0
    out = k3.gather_packed(packed, idx)
    assert k3.launches == 1
    assert torch.equal(out, k3.gather_packed_plain(packed, idx))


@pytest.mark.cuda
def test_dlt_nullspaces_on_the_card_past_one_eigh_batch(cuda):
    """The DLT's float32 eigh on the card over more matrices than one
    cuSOLVER batch takes: the polished null vectors equal numpy's
    float64 eigh up to sign."""
    from cybervision_tpu_torch.ops import sfm_device

    rng = np.random.RandomState(9)
    t = 2 * sfm_device.DLT_EIGH_BATCH + 5
    basis = rng.randn(t, 4, 3)
    ata = np.einsum("tij,tkj->tik", basis, basis)  # rank 3: an exact null vector
    h = sfm_device.dlt_nullspaces(ata, device=cuda)
    ref = np.linalg.eigh(ata)[1][:, :, 0]
    np.testing.assert_allclose(np.abs(np.einsum("ti,ti->t", h, ref)), 1.0, atol=1e-9)
