"""Coarse-to-fine dense epipolar NCC correlation (the affine subset of
cybervision_tpu/ops/correlation.py, in PyTorch).

Reference behaviour (correlation/mod.rs): for every pixel of img1, walk
its epipolar line in img2 with +-corridor_size lateral stripes, scoring
11x11 zero-mean NCC; the coarsest scale searches the full corridor, every
finer scale a per-pixel window derived from the previous scale's
matches; forward and reverse directions are cross-checked each scale.

The port keeps the JAX package's formulation function for function:
  * first_pass: the exact all-pairs patch correlation as one masked
    (P1, 121) x (121, P2) product per chunk of img1's pixels
    (torch.matmul);
  * refine_pass: prologue (window stats, epipolar fields, corridor
    ranges, stripe base warps) in PyTorch, the hypothesis sweep in
    kernel K1 (ops.ncc_sweep) — on the card for every refine level;
  * cross_check: the interval-bound mutual-consistency relaxation, and
    cross_check_exact, the reference's exact test
    (CorrelationConfig.exact_cross_check);
  * correlate_images: the fixed-window pyramid with its coarse-reach
    escalation to data-driven windows and the bucketed finest level.

Every level runs on row slabs: global rows [r0, r0 + hs) of the level
image, each computed from global coordinates. Without a mesh one slab
holds the whole level. Under a parallel.Mesh a level whose rows make
shards at least KS deep (in both directions) lives row-sharded from
resize to cross-check, slab i on mesh.devices[i], as the JAX package's
constrain_rows pins it (cybervision_tpu/ops/correlation.py:1552-1591);
nothing is gathered between levels, and the final state is gathered
once. What a slab reads beyond its rows comes as follows:
  * the full-resolution images and F: on every device (one copy each);
  * the level images: resized per slab, then all-gathered, since the
    first pass, the stripe warps and the sweep read img2 along the
    corridor and img1 KS rows beyond the slab;
  * the previous level's state: the rows (r0+1)//2 - 5 to
    (r0+hs)//2 + 4 that the neighbour statistics read
    (parallel.row_window, a halo of the previous level's shards);
  * the corridor's band means: every row's partial sums, all-gathered
    and reduced in one fixed order (parallel.tree_sum);
  * the cross-checks: the reverse state's dilated bounds (a +-4-row
    halo) or its packed plane, all-gathered.
The library products (the resize passes, the first pass) run in the
same global blocks whatever the slabs, and every other step is per
element, so each slab equals the same rows of the unsharded run bit for
bit. The sweep of a level whose shards are also one K1 halo deep
(ops.ncc_sweep.shardable_rows) runs as K1s, ncc_sweep_sharded, on the
slabs' fields; a shallower one gathers them and runs K1 on the lead.

Device paths run in float32/int32; host-side decisions (warp buckets,
uniform axes) run in float64 numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

from cybervision_tpu_torch.config import (
    CorrelationConfig,
    ProjectionMode,
    pyramid_scales,
)
from cybervision_tpu_torch.ops.ncc_sweep import (
    ncc_sweep,
    ncc_sweep_sharded,
    shardable_rows,
    shift,
)
from cybervision_tpu_torch.parallel import (
    AUTO,
    Mesh,
    RowShards,
    all_gather_rows,
    assert_spans_mesh,
    gather_rows,
    replicate,
    resolve_mesh,
    row_window,
    shard_rows,
    tree_sum,
)

KS = 5  # kernel half-width (correlation/mod.rs:16)
KW = 2 * KS + 1
KPC = KW * KW

F32 = torch.float32
I32 = torch.int32


class CorrelationState(NamedTuple):
    """Per-direction match state at the current pyramid scale.

    pos: (H, W, 2) int32 full-resolution (x, y) of the match in the
         other image; corr: (H, W) f32 best NCC; valid: (H, W) bool.
    Under a mesh each field is a parallel.RowShards of those planes.
    """

    pos: torch.Tensor
    corr: torch.Tensor
    valid: torch.Tensor


def empty_state(h: int, w: int, device) -> CorrelationState:
    return CorrelationState(
        pos=torch.zeros((h, w, 2), dtype=I32, device=device),
        corr=torch.full((h, w), -1.0, dtype=F32, device=device),
        valid=torch.zeros((h, w), dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# Row slabs


def _one(x: torch.Tensor) -> RowShards:
    """A whole tensor as the RowShards of one slab."""
    return RowShards((x,), x.shape[0], x.shape[0])


def _rows(x: torch.Tensor, lo: int, hi: int, fill=0) -> torch.Tensor:
    """Rows [lo, hi) of a whole tensor, `fill` outside it."""
    return row_window(_one(x), lo, hi, x.device, fill)


def _sharded_state(parts: list[CorrelationState], h: int) -> CorrelationState:
    """Per-slab states of hs rows each as one state of RowShards."""
    hs = parts[0].corr.shape[0]
    return CorrelationState(*(
        RowShards(tuple(p[k] for p in parts), h, hs) for k in range(3)
    ))


def _slab_states(state: CorrelationState) -> list[CorrelationState]:
    return [CorrelationState(*t) for t in zip(*(f.parts for f in state))]


def _state_on(mesh: Mesh, state: CorrelationState) -> CorrelationState:
    """A state (whole, or RowShards of any mesh) as RowShards over `mesh`."""
    if isinstance(state.valid, RowShards):
        if tuple(p.device for p in state.valid.parts) == mesh.devices:
            return state
        state = gather_state(state, mesh.lead)
    if mesh.size == 1:
        return CorrelationState(*(_one(t.to(mesh.lead)) for t in state))
    return CorrelationState(*(shard_rows(mesh, t) for t in state))


def gather_state(state: CorrelationState, device) -> CorrelationState:
    """A row-sharded state whole on `device` (a whole one moved there)."""
    if isinstance(state.valid, RowShards):
        return CorrelationState(*(gather_rows(t, device) for t in state))
    return CorrelationState(*(t.to(device) for t in state))


def _global_rows(r0: int, hs: int, device) -> torch.Tensor:
    return torch.arange(r0, r0 + hs, device=device)[:, None]


def _margin_mask(r0: int, hs: int, h: int, w: int, device) -> torch.Tensor:
    """The in-margin mask of rows [r0, r0 + hs) of an h x w image."""
    ys = _global_rows(r0, hs, device)
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= KS) & (ys < h - KS) & (xs >= KS) & (xs < w - KS)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f64::round semantics: halves round AWAY from zero (2.5 -> 3,
    -2.5 -> -3). torch.round is half-to-even and diverges on every exact
    half — which the corridor math hits systematically (mod.rs:530-538)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _box11(x: torch.Tensor) -> torch.Tensor:
    """11x11 window sum ('same' size, wrapping at the borders, which
    callers mask). Two separable passes of 11 rolled adds."""
    acc = torch.zeros_like(x)
    for dx in range(-KS, KS + 1):
        acc = acc + torch.roll(x, -dx, dims=-1)
    out = torch.zeros_like(x)
    for dy in range(-KS, KS + 1):
        out = out + torch.roll(acc, -dy, dims=-2)
    return out


def window_stats(img: torch.Tensor):
    """Per-pixel 11x11 mean and population stdev, plus the in-margin mask
    (correlation/mod.rs:657-694). Returns (avg, stdev, margin_valid)."""
    img = img.to(F32)
    n = float(KPC)
    avg = _box11(img) / n
    var = torch.clamp(_box11(img * img) / n - avg * avg, min=0.0)
    stdev = torch.sqrt(var)
    h, w = img.shape
    return avg, stdev, _margin_mask(0, h, h, w, img.device)


def _slab_window_stats(img_w: torch.Tensor, r0: int, h: int):
    """window_stats of rows [r0, r0 + hs) of an h-row image from img_w,
    its rows [r0 - KS, r0 + hs + KS) (zero outside the image): the own
    rows' 11x11 sums see their real neighbours, the margin mask tests
    global rows. Returns (avg, stdev, margin_valid) of the own rows."""
    avg, sd, _ = window_stats(img_w)
    hs = img_w.shape[0] - 2 * KS
    return (avg[KS : KS + hs], sd[KS : KS + hs],
            _margin_mask(r0, hs, h, img_w.shape[1], img_w.device))


# ---------------------------------------------------------------------------
# Epipolar geometry per pixel


def epipolar_fields(
    f: torch.Tensor, h: int, w: int, scale: float,
    force_vert: bool | None = None, row0: int = 0,
):
    """Per-pixel corridor parametrization (correlation/mod.rs:386-409) of
    the h rows from global row row0 of a w-wide image. f is a (3, 3)
    float32 tensor. force_vert pins the dominant axis globally instead
    of the per-pixel |a| > |b| test.

    Returns dict: vert (H, W) bool, coeff/add (H, W) f32 (off-axis
    coordinate = coeff * i + add), finite (H, W) bool."""
    dev = f.device
    ar_w = torch.arange(w, dtype=F32, device=dev)[None, :]
    ar_h = torch.arange(row0, row0 + h, dtype=F32, device=dev)[:, None]
    ys = ar_h / scale
    xs = ar_w / scale
    a = f[0, 0] * xs + f[0, 1] * ys + f[0, 2]
    b = f[1, 0] * xs + f[1, 1] * ys + f[1, 2]
    # scale*c folded exactly into pixel units (cybervision_tpu
    # correlation.epipolar_fields: avoids an ulp of /scale round trip).
    sc = f[2, 0] * ar_w + f[2, 1] * ar_h + scale * f[2, 2]
    a = a.expand(h, w)
    b = b.expand(h, w)
    sc = sc.expand(h, w)
    if force_vert is None:
        vert = torch.abs(a) > torch.abs(b)
    else:
        vert = torch.full((h, w), bool(force_vert), device=dev)
    denom = torch.where(vert, a, b)
    safe = torch.where(torch.abs(denom) > 0, denom, torch.ones_like(denom))
    coeff = torch.where(vert, -b, -a) / safe
    add = -sc / safe
    finite = torch.isfinite(coeff) & torch.isfinite(add) & (torch.abs(denom) > 0)
    return {"vert": vert, "coeff": coeff, "add": add, "finite": finite}


def uniform_epipolar_axis(
    f: np.ndarray, scale: float, h: int, w: int
) -> str | None:
    """Host-side proof that epipolar_fields' per-pixel dominant axis is
    constant over the (h, w) grid — "vert"/"horiz" — or None. |a| > |b|
    iff (a-b)(a+b) > 0, and an affine function with one strict sign at
    the four rect corners has it everywhere inside (f64, with a margin
    covering the f32 evaluation error)."""
    f = np.asarray(f, np.float64)
    d_vals, s_vals, mags = [], [], []
    for x in (0.0, (w - 1) / scale):
        for y in (0.0, (h - 1) / scale):
            a = f[0, 0] * x + f[0, 1] * y + f[0, 2]
            b = f[1, 0] * x + f[1, 1] * y + f[1, 2]
            d_vals.append(a - b)
            s_vals.append(a + b)
            mags.append(
                abs(f[0, 0] * x) + abs(f[0, 1] * y) + abs(f[0, 2])
                + abs(f[1, 0] * x) + abs(f[1, 1] * y) + abs(f[1, 2])
            )
    margin = 1e-4 * max(max(mags), 1e-30)
    d = np.asarray(d_vals)
    s = np.asarray(s_vals)
    if (
        np.all(np.abs(d) > margin)
        and np.all(np.abs(s) > margin)
        and np.all(np.sign(d) == np.sign(d[0]))
        and np.all(np.sign(s) == np.sign(s[0]))
    ):
        return "vert" if np.sign(d[0]) * np.sign(s[0]) > 0 else "horiz"
    return None


def _resolved_axis(
    wtr: tuple[str, int, int] | None, forced: str | None
) -> str | None:
    """The static epipolar axis a sweep runs with: the warp bucket's axis
    when present (affine F), else the host-proven uniform axis, else None
    (per-pixel)."""
    return wtr[0] if wtr is not None else forced


# ---------------------------------------------------------------------------
# First (coarsest) pass: exact all-pairs patch product


def _patches(img, avg, sd, inv_n: bool) -> torch.Tensor:
    """(H*W, 121) zero-mean normalised patches (margin rows are garbage
    and masked by validity)."""
    cols = [
        torch.roll(img, (-dy, -dx), dims=(0, 1))
        for dy in range(-KS, KS + 1)
        for dx in range(-KS, KS + 1)
    ]
    p = torch.stack(cols, dim=-1) - avg[:, :, None]
    denom = torch.clamp(sd, min=1e-12)[:, :, None]
    p = p / (denom * KPC) if inv_n else p / denom
    return p.reshape(-1, KPC)


def _first_pass_table(img2: torch.Tensor, min_stdev: float) -> dict:
    """The whole img2 side of first_pass on img2's device: its (P2, 121)
    patches, candidate coordinates and validity."""
    img2 = img2.to(F32)
    h2, w2 = img2.shape
    dev = img2.device
    avg2, sd2, ok2 = window_stats(img2)
    q_y = torch.arange(h2, dtype=F32, device=dev)[:, None].expand(h2, w2).reshape(-1)
    q_x = torch.arange(w2, dtype=F32, device=dev)[None, :].expand(h2, w2).reshape(-1)
    return {
        "a2": _patches(img2, avg2, sd2, inv_n=False), "q_x": q_x, "q_y": q_y,
        "q_xi": q_x.to(I32), "q_yi": q_y.to(I32),
        "q_ok": (ok2 & (sd2 >= min_stdev)).reshape(-1), "h2": h2, "w2": w2,
    }


def _first_pass_slab(
    img1_w: torch.Tensor, table: dict, f: torch.Tensor, scale: float,
    threshold: float, min_stdev: float, corridor_size: int, r0: int, h1: int,
) -> CorrelationState:
    """first_pass for rows [r0, r0 + hs) of an h1-row img1, from img1_w,
    its rows [r0 - KS, r0 + hs + KS) (zero outside), and img2's table.
    The product runs in chunks of img1's pixels cut at the same global
    pixel indices whatever the slab, each chunk a fresh (chunk, 121)
    operand with the slab's pixels at their place in it and zeros for
    the others: every product has the unsharded run's shape and its
    rows' bits. Rows from h1 on are invalid."""
    hs = img1_w.shape[0] - 2 * KS
    w1 = img1_w.shape[1]
    dev = img1_w.device
    img1_w = img1_w.to(F32)
    avg_w, sd_w, _ = window_stats(img1_w)
    a1 = _patches(img1_w, avg_w, sd_w, inv_n=True).reshape(hs + 2 * KS, w1, KPC)
    a1 = a1[KS : KS + hs].reshape(-1, KPC)
    sd1 = sd_w[KS : KS + hs]
    ok1 = _margin_mask(r0, hs, h1, w1, dev)
    ep = epipolar_fields(f, hs, w1, scale, row0=r0)
    a2, q_x, q_y, q_ok = table["a2"], table["q_x"], table["q_y"], table["q_ok"]
    h2, w2 = table["h2"], table["w2"]
    p_valid = (ok1 & (sd1 >= min_stdev) & ep["finite"]).reshape(-1)
    vert = ep["vert"].reshape(-1)
    coeff = ep["coeff"].reshape(-1)
    add = ep["add"].reshape(-1)

    cs = float(corridor_size)
    dom_max = float(max(h2, w2))
    chunk = max(1, (1 << 22) // max(a2.shape[0], 1))
    n_pix = h1 * w1
    p0, p1 = r0 * w1, min(r0 + hs, h1) * w1
    best_corr = torch.full((hs * w1,), -torch.inf, dtype=F32, device=dev)
    bx = torch.zeros(hs * w1, dtype=I32, device=dev)
    by = torch.zeros(hs * w1, dtype=I32, device=dev)
    end_v = torch.tensor(float(h2 - KS), device=dev)
    end_h = torch.tensor(float(w2 - KS), device=dev)
    for c0 in range(p0 - p0 % chunk, p1, chunk):
        c1 = min(c0 + chunk, n_pix)
        lo, hi = max(c0, p0), min(c1, p1)
        a = a1.new_zeros((c1 - c0, KPC))
        a[lo - c0 : hi - c0] = a1[lo - p0 : hi - p0]
        corr = (a @ a2.T)[lo - c0 : hi - c0]  # (pixels, P2)
        sl = slice(lo - p0, hi - p0)
        vb = vert[sl][:, None]
        i_coord = torch.where(vb, q_y[None, :], q_x[None, :])
        off_coord = torch.where(vb, q_x[None, :], q_y[None, :])
        line = torch.floor(coeff[sl][:, None] * i_coord + add[sl][:, None])
        on_band = torch.abs(off_coord - line) <= cs
        end = torch.where(vert[sl], end_v, end_h)
        in_range = (i_coord >= float(KS)) & (i_coord < end[:, None])
        ok = on_band & in_range & q_ok[None, :] & p_valid[sl][:, None]
        ok &= corr >= threshold
        corr = torch.where(ok, corr, -torch.inf)
        val = torch.max(corr, dim=1).values
        key = torch.where(
            ok & (corr == val[:, None]),
            ((off_coord - line) + cs) * dom_max + i_coord,
            torch.inf,
        )
        best = torch.argmin(key, dim=1)
        hit = torch.isfinite(val)
        best_corr[sl] = val
        bx[sl] = torch.where(hit, table["q_xi"][best], 0)
        by[sl] = torch.where(hit, table["q_yi"][best], 0)
    return _match_state(
        best_corr.reshape(hs, w1), bx.reshape(hs, w1), by.reshape(hs, w1),
        scale, r0, h1,
    )


def _match_state(best_corr, best_x, best_y, scale: float, r0: int, h: int) -> CorrelationState:
    """A pass's (corr, x, y) of rows [r0, r0 + hs) at this scale as a
    state: valid where the corr is finite and the row lies inside the
    h-row level."""
    inv_s = int(round(1.0 / scale))
    valid = torch.isfinite(best_corr) & (_global_rows(r0, best_corr.shape[0], best_corr.device) < h)
    pos = torch.stack([best_x * inv_s, best_y * inv_s], dim=-1)
    return CorrelationState(
        pos=torch.where(valid[:, :, None], pos, 0),
        corr=torch.where(valid, best_corr, -1.0),
        valid=valid,
    )


def first_pass(
    img1: torch.Tensor,
    img2: torch.Tensor,
    f: torch.Tensor,
    scale: float,
    threshold: float,
    min_stdev: float,
    corridor_size: int,
) -> CorrelationState:
    """Full-corridor exact NCC search at the coarsest scale.

    corr(p, q) = <d1(p)/(121*s1), d2(q)/s2> over 11x11 zero-mean patches,
    computed as a chunked product (torch.matmul, float32 — TF32 off,
    PyTorch's default); candidates masked to q on p's corridor band with
    |lateral offset| <= corridor_size and corridor index within
    [KS, dim - KS). Equal-NCC ties resolve in the reference's walk order
    (mod.rs:372-381): smallest lateral offset, then smallest corridor
    index.
    """
    h1 = img1.shape[0]
    return _first_pass_slab(
        _rows(img1, -KS, h1 + KS), _first_pass_table(img2, min_stdev), f,
        scale, threshold, min_stdev, corridor_size, 0, h1,
    )


# ---------------------------------------------------------------------------
# Search-range estimation from the previous scale


def _upsample2_shift(prev: torch.Tensor, j: int, n_cur: int):
    """prev[(p+1)//2 + j - 5] along the last axis, zero-padded."""
    idx = torch.div(
        torch.arange(n_cur, device=prev.device) + 1, 2, rounding_mode="floor"
    ) + (j - 5)
    ok = (idx >= 0) & (idx < prev.shape[-1])
    idx = torch.clamp(idx, 0, prev.shape[-1] - 1)
    return torch.index_select(prev, prev.ndim - 1, idx), ok


def _prev_rows(r0: int, hs: int) -> tuple[int, int]:
    """The previous level's rows [lo, hi) that _neighbor_stats reads for
    level rows [r0, r0 + hs): (p + 1)//2 + j - 5 for j in [0, 10)."""
    return (r0 + 1) // 2 - 5, (r0 + hs) // 2 + 5


def _prev_window(prev: CorrelationState, r0: int, hs: int, device):
    """The previous level's state rows _neighbor_stats reads for level
    rows [r0, r0 + hs), on `device` (invalid outside the level), and the
    first of them. prev is a state of RowShards."""
    lo, hi = _prev_rows(r0, hs)
    win = CorrelationState(
        pos=row_window(prev.pos, lo, hi, device, 0), corr=None,
        valid=row_window(prev.valid, lo, hi, device, False),
    )
    return win, lo


def _neighbor_stats(
    prev: CorrelationState, h: int, w: int, scale: float,
    r0: int = 0, p0: int = 0, hp: int | None = None,
):
    """Mean/stdev/count of neighbor match positions, both axes
    (cybervision_tpu correlation._neighbor_stats: the reference's 10 px
    scan, correlation/mod.rs:481-517, is exactly the previous-scale
    cells [ceil(p/2)-5, ceil(p/2)+4]; accumulation is query-relative so
    the variance stays exact in f32), for the h level rows from global
    row r0. prev holds the previous level's rows [p0, p0 + len) of its
    hp (default: prev is the whole previous level), invalid outside.

    Returns (count, mean_x, mean_y, var_x, var_y, mean_src_x, mean_src_y)."""
    dev = prev.valid.device
    px = prev.pos[:, :, 0].to(F32) * scale
    py = prev.pos[:, :, 1].to(F32) * scale
    hw, wp = prev.valid.shape
    hp = hw if hp is None else hp
    src_x = (2.0 * torch.arange(wp, dtype=F32, device=dev)[None, :]).expand(hw, wp)
    src_y = (2.0 * torch.arange(p0, p0 + hw, dtype=F32, device=dev)[:, None]).expand(hw, wp)
    v = prev.valid.to(F32)
    ux = (px - src_x) * v
    uy = (py - src_y) * v

    def up_axis1(arr, j):
        out, ok = _upsample2_shift(arr, j, w)
        return out * ok

    half = torch.div(_global_rows(r0, h, dev)[:, 0] + 1, 2, rounding_mode="floor")

    def up_axis0(arr, j):
        idx = half + (j - 5)
        ok = (idx >= 0) & (idx < hp)
        out = torch.index_select(arr, 0, torch.clamp(idx - p0, 0, hw - 1))
        return out * ok[:, None]

    row_cnt = torch.zeros((hw, w), dtype=F32, device=dev)
    row_wx = torch.zeros_like(row_cnt)
    row_wx2 = torch.zeros_like(row_cnt)
    row_uy = torch.zeros_like(row_cnt)
    row_uy2 = torch.zeros_like(row_cnt)
    row_dxn = torch.zeros_like(row_cnt)
    for jx in range(10):
        dx = float(jx - 5)
        vv = up_axis1(v, jx)
        uxv = up_axis1(ux, jx)
        row_cnt += vv
        row_wx += uxv + (2.0 * dx) * vv
        row_wx2 += up_axis1(ux * ux, jx) + (4.0 * dx) * uxv + (4.0 * dx * dx) * vv
        row_uy += up_axis1(uy, jx)
        row_uy2 += up_axis1(uy * uy, jx)
        row_dxn += dx * vv

    cnt = torch.zeros((h, w), dtype=F32, device=dev)
    wx = torch.zeros_like(cnt)
    wx2 = torch.zeros_like(cnt)
    wy = torch.zeros_like(cnt)
    wy2 = torch.zeros_like(cnt)
    dxn = torch.zeros_like(cnt)
    dyn = torch.zeros_like(cnt)
    for jy in range(10):
        dy = float(jy - 5)
        rc = up_axis0(row_cnt, jy)
        ruy = up_axis0(row_uy, jy)
        cnt += rc
        wx += up_axis0(row_wx, jy)
        wx2 += up_axis0(row_wx2, jy)
        wy += ruy + (2.0 * dy) * rc
        wy2 += up_axis0(row_uy2, jy) + (4.0 * dy) * ruy + (4.0 * dy * dy) * rc
        dxn += up_axis0(row_dxn, jy)
        dyn += dy * rc

    bx = (2 * torch.div(torch.arange(w, device=dev) + 1, 2, rounding_mode="floor")).to(F32)[None, :]
    by = (2 * half).to(F32)[:, None]
    n = torch.clamp(cnt, min=1.0)
    mx_rel = wx / n
    my_rel = wy / n
    mean_x = bx + mx_rel
    mean_y = by + my_rel
    var_x = torch.clamp(wx2 / n - mx_rel * mx_rel, min=0.0)
    var_y = torch.clamp(wy2 / n - my_rel * my_rel, min=0.0)
    mean_src_x = bx + 2.0 * dxn / n
    mean_src_y = by + 2.0 * dyn / n
    return cnt, mean_x, mean_y, var_x, var_y, mean_src_x, mean_src_y


_ANCHOR_BAND = 128


def _band_size(n: int) -> int:
    """Anchor-band width along an axis of length n; shared by the band
    means and _stripe_warps_fast, which must agree. Axes shorter than
    two bands collapse to one global band."""
    return _ANCHOR_BAND if n >= 2 * _ANCHOR_BAND else max(n, 1)


def _band_partials(disp: torch.Tensor, weight: torch.Tensor, axis: int):
    """Each row's partial sums (num, den) of disp * weight and weight for
    the band means along `axis`: over every column band ((rows, nb),
    axis 1) or over the whole row ((rows, 1), axis 0), in tree_sum's
    order."""
    h, w = disp.shape
    dw = disp * weight
    if axis == 0:
        return tree_sum(dw, 1)[:, None], tree_sum(weight, 1)[:, None]
    b = _band_size(w)
    nb = (w + b - 1) // b
    pad = nb * b - w
    dw = torch.nn.functional.pad(dw, (0, pad)).reshape(h, nb, b)
    ww = torch.nn.functional.pad(weight, (0, pad)).reshape(h, nb, b)
    return tree_sum(dw, 2), tree_sum(ww, 2)


def _band_means_of_rows(num: torch.Tensor, den: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """The weighted mean of disp per _ANCHOR_BAND-wide band along
    `axis` from every row's partials (_band_partials over all h rows, in
    row order), as one value per cell of that axis (n of them); empty
    bands take the global weighted mean. The rows reduce in tree_sum's
    order, so the sums do not depend on how the rows were cut."""
    if axis == 0:
        h = num.shape[0]
        b = _band_size(h)
        nb = (h + b - 1) // b
        pad = nb * b - h
        num = tree_sum(torch.nn.functional.pad(num[:, 0], (0, pad)).reshape(nb, b), 1)
        den = tree_sum(torch.nn.functional.pad(den[:, 0], (0, pad)).reshape(nb, b), 1)
    else:
        b = _band_size(n)
        num, den = tree_sum(num, 0), tree_sum(den, 0)
    g = tree_sum(num, 0) / torch.clamp(tree_sum(den, 0), min=1.0)
    band = torch.where(den > 0, num / torch.clamp(den, min=1.0), g)
    return torch.repeat_interleave(band, b)[:n]


@dataclasses.dataclass
class _Corridor:
    """One slab's corridor: its epipolar fields, neighbour statistics and
    (once the band means are in) center/start/end and has_neighbors."""

    r0: int
    ep: dict
    stats: tuple
    center: torch.Tensor | None = None
    start: torch.Tensor | None = None
    end: torch.Tensor | None = None
    has: torch.Tensor | None = None


def _corridors(
    mesh: Mesh, prev: CorrelationState, fs: dict, h: int, w: int, h2: int,
    w2: int, scale: float, min_range: float, extend_range: float,
    force_vert: bool | None,
) -> list[_Corridor]:
    """Per-pixel corridors along the dominant axis (correlation/mod.rs:
    468-540) of the h x w level image's slabs over `mesh`: center, start,
    end (int32) and has_neighbors (bool) per slab. prev is the previous
    level's state (RowShards of any layout); fs maps each device to F.

    The sweep anchor `center` is globally slope-1 along the dominant axis
    (p_dom + round(band-mean disparity)), so the shifted base warp is the
    exact candidate patch at every pixel; [start, end) keeps the
    reference's round(mid) +- length corridor exactly. The band means
    reduce across every slab's rows: each slab's row partials are
    all-gathered and every device reduces them in the same order."""
    hs = -(-h // mesh.size)
    hp = prev.valid.h
    out, partials = [], []
    for i, dev in enumerate(mesh.devices):
        r0 = i * hs
        win, p0 = _prev_window(prev, r0, hs, dev)
        ep = epipolar_fields(fs[dev], hs, w, scale, force_vert, row0=r0)
        stats = _neighbor_stats(win, hs, w, scale, r0=r0, p0=p0, hp=hp)
        cnt, mean_x, mean_y, _, _, src_x, src_y = stats
        vert = ep["vert"]
        disp = torch.where(vert, mean_y - src_y, mean_x - src_x)
        hasf = (cnt > 0).to(F32)
        vf = vert.to(F32) * hasf
        hf = (1.0 - vert.to(F32)) * hasf
        partials.append(torch.cat(
            [*_band_partials(disp, vf, 1), *_band_partials(disp, hf, 0)], dim=1
        ))
        out.append(_Corridor(r0, ep, stats))
    nb = (partials[0].shape[1] - 2) // 2
    means = {}
    for dev, rows in zip(mesh.devices, all_gather_rows(RowShards(tuple(partials), h, hs), mesh)):
        if dev not in means:
            d_vert = _band_means_of_rows(rows[:, :nb], rows[:, nb : 2 * nb], 1, w)
            d_horiz = _band_means_of_rows(rows[:, 2 * nb : 2 * nb + 1], rows[:, 2 * nb + 1 :], 0, h)
            means[dev] = (d_vert, torch.nn.functional.pad(d_horiz, (0, mesh.size * hs - h)))
    lo = float(KS)
    for c, dev in zip(out, mesh.devices):
        d_vert, d_horiz = means[dev]
        cnt, mean_x, mean_y, var_x, var_y, _, _ = c.stats
        vert = c.ep["vert"]
        mid = torch.where(vert, mean_y, mean_x)
        stdev = torch.sqrt(torch.where(vert, var_y, var_x))
        ys_dom = torch.arange(c.r0, c.r0 + hs, dtype=F32, device=dev)[:, None]
        xs_dom = torch.arange(w, dtype=F32, device=dev)[None, :]
        dom = torch.where(vert, ys_dom, xs_dom)
        band = torch.where(vert, d_vert[None, :], d_horiz[c.r0 : c.r0 + hs, None])
        center = dom + torch.round(band)
        ref_center = _round_half_away(mid)
        length = _round_half_away(min_range + stdev * extend_range)
        end_lim = torch.where(
            vert,
            torch.tensor(float(h2 - KS), device=dev),
            torch.tensor(float(w2 - KS), device=dev),
        )
        start = torch.minimum(torch.maximum(ref_center - length, torch.tensor(lo, device=dev)), end_lim)
        end = torch.minimum(torch.maximum(ref_center + length, start), end_lim)
        c.center, c.start, c.end, c.has = center.to(I32), start.to(I32), end.to(I32), cnt > 0
    return out


def _reach(corridors: list[_Corridor], h: int) -> torch.Tensor:
    """Maximum center-relative reach of any pixel's corridor in the h
    level rows — picks the sweep window bucket."""
    reach = []
    for c in corridors:
        r = torch.maximum(c.center - c.start, c.end - 1 - c.center)
        inside = c.has & (_global_rows(c.r0, r.shape[0], r.device) < h)
        reach.append(torch.max(torch.where(inside, r, 0)).to(corridors[0].center.device))
    return torch.max(torch.stack(reach))


# ---------------------------------------------------------------------------
# Refine pass: base warps + kernel K1 sweep


def warp_shift_range(
    f: np.ndarray, scale: float, h: int, w: int, h2: int, w2: int
) -> tuple[str, int, int] | None:
    """Host-side test: can the stripe base warps be built from shifts and
    selects instead of 2D gathers? For an affine F (zero 2x2 upper block,
    fundamentalmatrix.rs:260-286) the dominant axis is uniform and the
    perpendicular offset t = floor(coeff*center + add) - p_perp is
    bounded; returns ("vert"|"horiz", tmin, tmax) when the bound spans at
    most 8 values, else None (gather warps)."""
    fa = np.abs(np.asarray(f, np.float64))
    if fa[:2, :2].max() > 1e-9 * max(fa.max(), 1e-30):
        return None
    a = float(f[0, 2])
    b = float(f[1, 2])
    if a == 0.0 and b == 0.0:
        return None
    vert = abs(a) > abs(b)
    denom = a if vert else b
    coeff = (-b if vert else -a) / denom
    vals = []
    for x in (0.0, float(w - 1)):
        for y in (0.0, float(h - 1)):
            sc = f[2, 0] * x + f[2, 1] * y + scale * f[2, 2]
            add = -sc / denom
            if vert:
                vals.append(coeff * y + add - x)
            else:
                vals.append(coeff * x + add - y)
    # t leaves the corner hull by |coeff|*D, D the anchor disparity,
    # bounded by the larger of both images' extents.
    dmax = float(max(h, w, h2, w2))
    lo = min(vals) - abs(coeff) * dmax
    hi = max(vals) + abs(coeff) * dmax
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return None
    tmin = int(np.floor(lo))
    tmax = int(np.floor(hi))
    if tmax - tmin + 1 > 8:
        return None
    return ("vert" if vert else "horiz", tmin, tmax)


def split_trange(
    trange: tuple[str, int, int] | None,
) -> tuple[tuple[str, int, int] | None, int]:
    """Split warp_shift_range's (axis, tmin, tmax) into the structural
    bucket (axis, k_n, t_pad) and the shift tmin (select count floored at
    2 and padding at 8, each rounded up to a power of two — the JAX
    package's buckets, kept so both packages build identical warps)."""
    if trange is None:
        return None, 0
    axis, tmin, tmax = trange
    kn = tmax - tmin + 1
    kb = 2
    while kb < kn:
        kb *= 2
    tp = 8
    while tp < max(-tmin, tmin + kb - 1):
        tp *= 2
    return (axis, kb, tp), tmin


def _stripe_warps_fast(
    img2f: torch.Tensor,
    center: torch.Tensor,
    t_src: torch.Tensor,
    corridor_size: int,
    tmin: int,
    k_n: int,
    t_pad: int,
    h1: int,
    row0: int = 0,
    w1: int | None = None,
    col0: int = 0,
) -> list[torch.Tensor]:
    """Gather-free stripe base warps, dominant axis = columns (horizontal
    corridors): W0_o(y, x) = img2[y + t(y, x) + o, x + D_band(y)]. One
    slice per anchor band applies the along-axis offset D; the
    perpendicular offset t spans k_n values from tmin as row shifts of
    the slice combined with equality selects. The vert case runs this on
    transposed arrays.

    center and t_src hold the rows [row0, row0 + R) and columns
    [col0, col0 + C) of an h1 x w1 plane (w1 default C); every band's
    slice is placed by the whole plane's geometry, so a piece equals the
    same rows and columns of the whole. Rows from h1 on are zero."""
    cs = corridor_size
    h2, w2 = img2f.shape
    n_rows, n_cols = center.shape
    w1 = n_cols if w1 is None else w1
    pr = t_pad + cs + 1 + abs(h1 - h2)
    xp = max(w1, w2)
    extra = max(0, col0 + n_cols - w1)
    imgp = torch.nn.functional.pad(img2f, (xp, xp + extra, pr, pr))
    ph, pw = imgp.shape[0], imgp.shape[1] - extra

    b = _band_size(h1)
    r_end = min(row0 + n_rows, h1)
    rows_idx = torch.arange(row0, row0 + n_rows, dtype=I32, device=img2f.device)[:, None]
    t_field = t_src - rows_idx - tmin
    bands = range(row0 // b, (r_end + b - 1) // b) if r_end > row0 else range(0)
    # D_band == center - x in each band (one host fetch), read at the
    # band's first row in this piece: the band means make it the same on
    # every row of the band.
    d_bands = (
        center[[max(i * b, row0) - row0 for i in bands], 0] - col0
    ).tolist() if len(bands) else []

    stripe_bands: list[list[torch.Tensor]] = [[] for _ in range(2 * cs + 1)]
    for i, d_band in zip(bands, d_bands):
        r0 = i * b
        rows = min(b, h1 - r0)
        # clamp like lax.dynamic_slice: a garbage previous-scale state
        # cannot push the slice outside the padded plane.
        d_i = min(max(int(d_band), -xp), xp + w2 - w1)
        size_r = rows + k_n - 1 + 2 * cs
        sr = min(max(r0 - cs + pr + tmin, 0), ph - size_r)
        sc = min(max(xp + d_i, 0), pw - w1) + col0
        blk = imgp[sr : sr + size_r, sc : sc + n_cols]
        a, e = max(r0, row0), min(r0 + rows, r_end)
        t_band = t_field[a - row0 : e - row0]
        for oi, o in enumerate(range(-cs, cs + 1)):
            acc = None
            for k in range(k_n):
                off = k + o + cs + (a - r0)
                sl = blk[off : off + (e - a)]
                acc = sl if acc is None else torch.where(t_band == k, sl, acc)
            stripe_bands[oi].append(acc)
    pad = row0 + n_rows - max(r_end, row0)
    if pad:
        zero = img2f.new_zeros((pad, n_cols))
        for parts in stripe_bands:
            parts.append(zero)
    return [torch.cat(parts, dim=0) for parts in stripe_bands]


def _stripe_warps(
    img2f: torch.Tensor,
    vert: torch.Tensor,
    center: torch.Tensor,
    base_x: torch.Tensor,
    base_y: torch.Tensor,
    corridor_size: int,
    h2: int,
    w2: int,
    warp_trange: tuple[str, int, int] | None,
    warp_tmin: int = 0,
    r0: int = 0,
    h1: int | None = None,
) -> list[torch.Tensor]:
    """Stripe base-warp stack W0_o of the rows [r0, r0 + hs) of an h1-row
    level (h1 default hs): the shift/select form for a warp bucket, else
    a gather (correct for any epipolar geometry)."""
    cs = corridor_size
    hs, w1 = center.shape
    h1 = hs if h1 is None else h1
    if warp_trange is not None:
        axis, k_n, t_pad = warp_trange
        if axis == "horiz":
            return _stripe_warps_fast(
                img2f, center, base_y, cs, warp_tmin, k_n, t_pad, h1, row0=r0,
            )
        w0s_t = _stripe_warps_fast(
            img2f.T, center.T, base_x.T, cs, warp_tmin, k_n, t_pad, w1,
            w1=h1, col0=r0,
        )
        return [w.T for w in w0s_t]
    out = []
    for o in range(-cs, cs + 1):
        qx = base_x + torch.where(vert, o, 0)
        qy = base_y + torch.where(vert, 0, o)
        out.append(
            img2f[torch.clamp(qy, 0, h2 - 1).long(), torch.clamp(qx, 0, w2 - 1).long()]
        )
    return out


_FIELDS = ("img1", "vert", "center", "coeff", "add", "avg1", "isd1", "start",
           "end", "p_ok", "w0")


def _sweep_fields(
    img1_w: torch.Tensor, img2f: torch.Tensor, c: _Corridor, h1: int,
    min_stdev: float, corridor_size: int,
    warp_trange: tuple[str, int, int] | None, warp_tmin: int,
) -> dict:
    """The refine prologue's K1 fields of one slab's rows [r0, r0 + hs)
    of an h1-row img1 (img1_w: its rows +- KS, zero outside), from its
    corridor and the whole img2 (float32) on its device. Rows from h1 on
    are zero, as shard_rows pads them."""
    hs = img1_w.shape[0] - 2 * KS
    h2, w2 = img2f.shape
    img1_w = img1_w.to(F32)
    avg1, sd1, ok1 = _slab_window_stats(img1_w, c.r0, h1)
    ep = c.ep
    p_ok = ok1 & (sd1 >= min_stdev) & ep["finite"] & c.has
    vert = ep["vert"]
    c_f = c.center.to(F32)
    off0 = torch.floor(ep["coeff"] * c_f + ep["add"]).to(I32)
    base_x = torch.where(vert, off0, c.center)
    base_y = torch.where(vert, c.center, off0)
    w0 = torch.stack(_stripe_warps(
        img2f, vert, c.center, base_x, base_y, corridor_size, h2, w2,
        warp_trange, warp_tmin, r0=c.r0, h1=h1,
    ))
    fields = dict(zip(_FIELDS, (
        img1_w[KS : KS + hs], vert.to(F32), c_f, ep["coeff"], ep["add"], avg1,
        1.0 / torch.clamp(sd1, min=1e-12), c.start.to(F32), c.end.to(F32),
        p_ok.to(F32), w0,
    )))
    pad = c.r0 + hs - h1
    if pad > 0:
        for k, v in fields.items():
            v.narrow(-2, hs - pad, pad).zero_()
    return {k: v.contiguous() for k, v in fields.items()}


def _level_direction(
    mesh: Mesh, img1: tuple, img2: tuple, prev: CorrelationState, fs: dict,
    scale: float, params, window: int, warp_trange, warp_tmin: int,
    force_axis: str | None, sweep_sharded: bool,
) -> CorrelationState:
    """One direction of a refine level over the slabs of `mesh`: img1 and
    img2 are the whole level images, entry i on mesh.devices[i] (uint8);
    prev the previous level's state (RowShards). The sweep runs as K1s
    over the slabs' fields when sweep_sharded, else as K1 on the lead
    (the fields gathered there). Returns a state of RowShards over
    `mesh`."""
    threshold, min_stdev, min_range, extend_range, cs = params
    axis = _resolved_axis(warp_trange, force_axis)
    h1, w1 = img1[0].shape
    h2, w2 = img2[0].shape
    fv = None if axis is None else axis == "vert"
    corridors = _corridors(
        mesh, prev, fs, h1, w1, h2, w2, scale, min_range, extend_range, fv,
    )
    hs = -(-h1 // mesh.size)
    img2f = {}
    fields = []
    for c, dev, im1, im2 in zip(corridors, mesh.devices, img1, img2):
        if dev not in img2f:
            img2f[dev] = im2.to(F32)
        fields.append(_sweep_fields(
            _rows(im1, c.r0 - KS, c.r0 + hs + KS), img2f[dev], c, h1,
            min_stdev, cs, warp_trange, warp_tmin,
        ))
    kw = dict(
        threshold=threshold, min_stdev=min_stdev, window=window,
        corridor_size=cs, h2=h2, w2=w2, axis=axis,
    )
    shards = {
        k: RowShards(tuple(fl[k] for fl in fields), h1, hs, 1 if k == "w0" else 0)
        for k in _FIELDS
    }
    if sweep_sharded:
        outs = [o.parts for o in ncc_sweep_sharded(mesh, *shards.values(), **kw)]
    else:
        whole = ncc_sweep(*(gather_rows(v, mesh.lead) for v in shards.values()), **kw)
        outs = [shard_rows(mesh, o).parts for o in whole]
    return _sharded_state([
        _match_state(*out, scale, i * hs, h1) for i, out in enumerate(zip(*outs))
    ], h1)


def sweep_inputs(
    img1: torch.Tensor,
    img2: torch.Tensor,
    prev: CorrelationState,
    f: torch.Tensor,
    scale: float,
    min_stdev: float,
    min_range: float,
    extend_range: float,
    corridor_size: int,
    warp_trange: tuple[str, int, int] | None = None,
    warp_tmin: int = 0,
    axis: str | None = None,
) -> dict:
    """The refine pass's prologue: window stats, epipolar fields, corridor
    ranges and the stripe base warps, as the positional field arguments
    of ops.ncc_sweep.ncc_sweep (img1, vert, center, coeff, add, avg1,
    isd1, start, end, p_ok, w0), all float32 and contiguous."""
    h1, w1 = img1.shape
    h2, w2 = img2.shape
    dev = img1.device
    (c,) = _corridors(
        Mesh((dev,)), _state_on(Mesh((dev,)), prev), {dev: f}, h1, w1, h2, w2,
        scale, min_range, extend_range, None if axis is None else axis == "vert",
    )
    return _sweep_fields(
        _rows(img1, -KS, h1 + KS), img2.to(F32), c, h1, min_stdev,
        corridor_size, warp_trange, warp_tmin,
    )


def refine_pass(
    img1: torch.Tensor,
    img2: torch.Tensor,
    prev: CorrelationState,
    f: torch.Tensor,
    scale: float,
    threshold: float,
    min_stdev: float,
    min_range: float,
    extend_range: float,
    corridor_size: int,
    window: int,
    warp_trange: tuple[str, int, int] | None = None,
    warp_tmin: int = 0,
    force_axis: str | None = None,
    mesh=None,
) -> CorrelationState:
    """One refine-scale sweep (cybervision_tpu correlation.refine_pass /
    refine_pass_pallas): prologue in PyTorch, hypothesis loop in K1.
    `window` is the corridor half-width bucket; warp_trange/warp_tmin
    the warp bucket (affine F); force_axis a host-proven uniform axis.
    With a mesh the prologue runs on img1's row shards over it, the
    sweep as ncc_sweep_sharded, and the state comes back whole to img1's
    device."""
    dev = img1.device
    m = mesh or Mesh((dev,))
    state = _level_direction(
        m, replicate(m, img1), replicate(m, img2), _state_on(m, prev),
        {d: f.to(d) for d in m.devices}, scale,
        (threshold, min_stdev, min_range, extend_range, corridor_size),
        window, warp_trange, warp_tmin, force_axis, mesh is not None,
    )
    return gather_state(state, dev)


# ---------------------------------------------------------------------------
# Cross-check filter


def _dilate9(x: torch.Tensor, reduce_fn, fill: int) -> torch.Tensor:
    """9x9 window reduce, separable (edge-filled)."""

    def pass_axis(v, axis):
        out = v
        for d in range(-4, 5):
            if d != 0:
                out = reduce_fn(out, shift(v, d, axis, fill))
        return out

    return pass_axis(pass_axis(x, 0), 1)


_BIG = 2**30


def _reverse_bounds(rev: CorrelationState, r0: int, hs: int, device) -> torch.Tensor:
    """cross_check's per-cell bounds of a reverse slab, rows [r0, r0 + hs):
    the min and max back-pointer (x, y) over the +-4 window of valid
    cells, (hs, wr, 4) int32 as (lo x, lo y, hi x, hi y). rev is a state
    of RowShards; the window's rows outside the slab come as a 4-row
    halo, invalid beyond the plane."""
    pos = row_window(rev.pos, r0 - 4, r0 + hs + 4, device, 0)
    valid = row_window(rev.valid, r0 - 4, r0 + hs + 4, device, False)[:, :, None]
    lo = _dilate9(torch.where(valid, pos, _BIG), torch.minimum, _BIG)
    hi = _dilate9(torch.where(valid, pos, -_BIG), torch.maximum, -_BIG)
    return torch.cat([lo, hi], dim=2)[4 : 4 + hs]


def _check_bounds(state: CorrelationState, bounds: torch.Tensor, scale: float, r0: int) -> CorrelationState:
    """cross_check of a slab of rows [r0, r0 + hs) against the reverse
    plane's whole bounds: one gather at each match."""
    hs, w = state.corr.shape
    hr, wr = bounds.shape[:2]
    dev = state.corr.device
    inv_s = int(round(1.0 / scale))
    sa = 4 * inv_s
    mx = torch.clamp(
        torch.div(state.pos[:, :, 0], inv_s, rounding_mode="floor"), 0, wr - 1
    ).long()
    my = torch.clamp(
        torch.div(state.pos[:, :, 1], inv_s, rounding_mode="floor"), 0, hr - 1
    ).long()
    g = bounds[my, mx]
    ys = _global_rows(r0, hs, dev).to(I32)
    xs = torch.arange(w, dtype=I32, device=dev)[None, :]
    p_fx = xs * inv_s
    p_fy = ys * inv_s
    found = (
        (g[:, :, 0] < p_fx + sa + 1)
        & (g[:, :, 2] >= p_fx - sa)
        & (g[:, :, 1] < p_fy + sa + 1)
        & (g[:, :, 3] >= p_fy - sa)
    )
    return _keep(state, state.valid & found)


def _keep(state: CorrelationState, keep: torch.Tensor) -> CorrelationState:
    return CorrelationState(
        pos=torch.where(keep[:, :, None], state.pos, 0),
        corr=torch.where(keep, state.corr, -1.0),
        valid=keep,
    )


def _reverse_packed(rev: CorrelationState, scale: float) -> torch.Tensor:
    """cross_check_exact's reverse plane of one slab: valid | bx << 1 |
    by << 14 per cell."""
    inv_s = int(round(1.0 / scale))
    bx = torch.div(rev.pos[:, :, 0], inv_s, rounding_mode="floor")
    by = torch.div(rev.pos[:, :, 1], inv_s, rounding_mode="floor")
    return torch.where(rev.valid, 1 + (bx << 1) + (by << 14), 0)


def _check_packed(state: CorrelationState, packed: torch.Tensor, scale: float, r0: int) -> CorrelationState:
    """cross_check_exact of a slab of rows [r0, r0 + hs) against the
    reverse plane's whole packed plane."""
    hs, w = state.corr.shape
    hr, wr = packed.shape
    packed = packed.reshape(-1)
    dev = state.corr.device
    inv_s = int(round(1.0 / scale))
    mx = torch.clamp(
        torch.div(state.pos[:, :, 0], inv_s, rounding_mode="floor"), 0, wr - 1
    )
    my = torch.clamp(
        torch.div(state.pos[:, :, 1], inv_s, rounding_mode="floor"), 0, hr - 1
    )
    xs = torch.arange(w, dtype=I32, device=dev)[None, :]
    ys = _global_rows(r0, hs, dev).to(I32)
    found = torch.zeros((hs, w), dtype=torch.bool, device=dev)
    for dy in range(-4, 5):
        qy = my + dy
        in_y = (qy >= 0) & (qy < hr)
        for dx in range(-4, 5):
            qx = mx + dx
            inside = in_y & (qx >= 0) & (qx < wr)
            flat = (qy.clamp(0, hr - 1) * wr + qx.clamp(0, wr - 1)).long()
            pk = torch.where(inside, packed[flat], 0)
            gbx = (pk >> 1) & 0x1FFF
            gby = pk >> 14
            found |= (
                ((pk & 1) == 1)
                & (gbx >= xs - 4) & (gbx <= xs + 4)
                & (gby >= ys - 4) & (gby <= ys + 4)
            )
    return _keep(state, state.valid & found)


def _cross_check_level(
    mesh: Mesh, state: CorrelationState, reverse: CorrelationState,
    scale: float, exact: bool,
) -> CorrelationState:
    """cross_check (or cross_check_exact) of a state of RowShards over
    `mesh` against the reverse direction's: the reverse plane's bounds
    (or packed plane) are built per reverse slab, all-gathered whole to
    every device, and each slab of `state` gathers at its matches."""
    hr = reverse.valid.h
    hs_r = reverse.valid.hs
    if exact:
        planes = [_reverse_packed(r, scale) for r in _slab_states(reverse)]
    else:
        planes = [
            _reverse_bounds(reverse, i * hs_r, hs_r, d)
            for i, d in enumerate(mesh.devices)
        ]
    whole = all_gather_rows(RowShards(tuple(planes), hr, hs_r), mesh)
    check = _check_packed if exact else _check_bounds
    hs = state.valid.hs
    return _sharded_state([
        check(s, g, scale, i * hs)
        for i, (s, g) in enumerate(zip(_slab_states(state), whole))
    ], state.valid.h)


def cross_check(
    state: CorrelationState, reverse: CorrelationState, scale: float
) -> CorrelationState:
    """Mutual-consistency filter (correlation/mod.rs:552-624), the JAX
    package's interval-bound relaxation: per reverse cell the min/max
    back-pointer over its +-4 window, then one gather at the match."""
    m = Mesh((state.corr.device,))
    out = _cross_check_level(m, _state_on(m, state), _state_on(m, reverse), scale, False)
    return gather_state(out, m.lead)


def cross_check_exact(
    state: CorrelationState, reverse: CorrelationState, scale: float
) -> CorrelationState:
    """Reference-exact mutual-consistency filter (correlation/mod.rs:
    552-624; the JAX package's packed single-gather form). A forward
    match m at cell p survives iff a valid reverse cell q within +-4
    cells of m points back to within +-4 cells of p, per axis, in cell
    units. The reverse plane packs valid | bx << 1 | by << 14.

    The JAX package gathers all 81 offsets' pre-shifted planes at once
    (81 x H x W int32, ~4 GB at 4032x3024); here each offset is one
    gather at the shifted index, out-of-range offsets reading an
    invalid 0 — the same test, so the same bits, in a few H x W planes."""
    m = Mesh((state.corr.device,))
    out = _cross_check_level(m, _state_on(m, state), _state_on(m, reverse), scale, True)
    return gather_state(out, m.lead)


# ---------------------------------------------------------------------------
# Pyramid resize


def _lanczos3_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of jax.image.resize(method="lanczos3",
    antialias=True): the kernel widens by 1/scale when downsampling,
    columns normalise to unit sum, samples outside the input are zero."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    radius = 3.0
    with np.errstate(divide="ignore", invalid="ignore"):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1.0), 1.0)
    weights = np.where(x > radius, 0.0, out)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0)


# Rows of output per resize block: each block is its own pair of
# products, cut at the same global rows whatever the slabs.
_RESIZE_BLOCK = 64


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int):
    """Lanczos3 weights (n_in, n_out) as float32, and per _RESIZE_BLOCK
    block of output cells the input range [lo, hi) its weights touch."""
    wts = _lanczos3_weights(n_in, n_out).astype(np.float32)
    spans = []
    for a in range(0, n_out, _RESIZE_BLOCK):
        nz = np.flatnonzero(np.any(wts[:, a : a + _RESIZE_BLOCK] != 0, axis=1))
        spans.append((int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1))
    return wts, spans


def _resize_rows(
    fullf: torch.Tensor, scale: float, r0: int, hs: int, wx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rows [r0, r0 + hs) of device_resize(full, scale) as uint8 (zero
    from the resized height on), from the full-resolution image as
    float32 on the output's device. The vertical pass runs per block of
    _RESIZE_BLOCK output rows over the input rows its weights touch, the
    horizontal one on each block's rows (wx: the (w, nw) weights on the
    device, uploaded when None), so every slab's rows are the same
    products as the whole image's."""
    h, w = fullf.shape
    nh, nw = resized_shape((h, w), scale)
    dev = fullf.device
    if scale == 1.0:
        return _rows(fullf, r0, r0 + hs).to(torch.uint8)
    wy, spans = _resize_weights(h, nh)
    if nw != w and wx is None:
        wx = torch.as_tensor(_resize_weights(w, nw)[0], device=dev)
    first = r0 - r0 % _RESIZE_BLOCK
    blocks = []
    for a in range(first, min(r0 + hs, nh), _RESIZE_BLOCK):
        b = min(a + _RESIZE_BLOCK, nh)
        x = fullf[a:b]
        if nh != h:
            lo, hi = spans[a // _RESIZE_BLOCK]
            x = torch.as_tensor(np.ascontiguousarray(wy[lo:hi, a:b].T), device=dev) @ fullf[lo:hi]
        if nw != w:
            x = x @ wx
        blocks.append(torch.clamp(torch.round(x), 0, 255).to(torch.uint8))
    if not blocks:
        return torch.zeros((hs, nw), dtype=torch.uint8, device=dev)
    out = torch.cat(blocks)[r0 - first : r0 - first + hs]
    if out.shape[0] < hs:
        out = torch.cat([out, out.new_zeros((hs - out.shape[0], nw))])
    return out


def device_resize(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Lanczos3 pyramid resize on the tensor's device, with the reference's
    truncated output dims ((w*scale) as u32, reconstruction.rs:148-150)
    and u8 quantisation (round half to even, like jnp.round). The two
    separable passes are float32 products with host-built weights, per
    block of _RESIZE_BLOCK output rows."""
    if scale == 1.0:
        return img
    nh = resized_shape(tuple(img.shape), scale)[0]
    return _resize_rows(img.to(F32), scale, 0, nh).to(img.dtype)


def resized_shape(shape: tuple[int, int], scale: float) -> tuple[int, int]:
    """Output dims of device_resize (truncated, reconstruction.rs:148-150)."""
    if scale == 1.0:
        return shape
    return int(shape[0] * scale), int(shape[1] * scale)


# ---------------------------------------------------------------------------
# Host-side pyramid loop


class _BandProgress:
    """Rescales a nested stage's [0, 1] progress into [lo, hi] of the
    outer listener (reconstruction.rs:866-893)."""

    def __init__(self, inner, lo: float, hi: float):
        self._inner = inner
        self._lo = lo
        self._span = hi - lo

    def report_status(self, pos: float) -> None:
        pos = min(max(pos, 0.0), 1.0)
        self._inner.report_status(self._lo + self._span * pos)


def normalize_f(f: np.ndarray) -> np.ndarray:
    """Scale F to unit maximum entry (f64): keeps the f32 per-pixel line
    evaluation exact for clean geometries."""
    f = np.asarray(f, np.float64)
    m = np.abs(f).max()
    return f / m if m > 0 else f


@dataclasses.dataclass(frozen=True)
class _Level:
    scale: float
    wtr_f: tuple[str, int, int] | None
    wtr_r: tuple[str, int, int] | None
    tmin_f: int
    tmin_r: int
    ax_f: str | None
    ax_r: str | None

    @property
    def fv_f(self):
        rax = _resolved_axis(self.wtr_f, self.ax_f)
        return None if rax is None else rax == "vert"

    @property
    def fv_r(self):
        rax = _resolved_axis(self.wtr_r, self.ax_r)
        return None if rax is None else rax == "vert"


def _plan_level(f: np.ndarray, scale: float, shape1, shape2) -> _Level:
    lh1, lw1 = resized_shape(shape1, scale)
    lh2, lw2 = resized_shape(shape2, scale)
    wtr_f, tmin_f = split_trange(warp_shift_range(f, scale, lh1, lw1, lh2, lw2))
    wtr_r, tmin_r = split_trange(warp_shift_range(f.T, scale, lh2, lw2, lh1, lw1))
    ax_f = None if wtr_f is not None else uniform_epipolar_axis(f, scale, lh1, lw1)
    ax_r = None if wtr_r is not None else uniform_epipolar_axis(f.T, scale, lh2, lw2)
    return _Level(scale, wtr_f, wtr_r, tmin_f, tmin_r, ax_f, ax_r)


class _Pair:
    """An image pair on every device of a correlate_images run (the
    mesh's, or the one device): the full-resolution images as uint8 and
    float32, F and F^T, each once per distinct device, and the
    horizontal resize weights per level width and device."""

    def __init__(self, devices, img1: np.ndarray, img2: np.ndarray, f: np.ndarray):
        devices = Mesh(tuple(devices)).devices  # "cuda" -> "cuda:<current>"
        self.lead = devices[0]
        self.shapes = (tuple(img1.shape), tuple(img2.shape))
        distinct = tuple(dict.fromkeys(devices))
        self.full = {d: (torch.tensor(img1, device=d), torch.tensor(img2, device=d))
                     for d in distinct}
        self.fullf = {d: tuple(x.to(F32) for x in self.full[d]) for d in distinct}
        self.fs = tuple(
            {d: torch.as_tensor(g, dtype=F32, device=d) for d in distinct}
            for g in (f, f.T.copy())
        )
        self._wx: dict = {}

    def level_images(self, mesh: Mesh, scale: float) -> list[tuple[torch.Tensor, ...]]:
        """Both level images whole on every mesh device (entry i on
        mesh.devices[i]): each shard resizes its rows, then they are
        all-gathered (one copy per distinct device)."""
        out = []
        for k, (h, w) in enumerate(self.shapes):
            if scale == 1.0:
                out.append(tuple(self.full[d][k] for d in mesh.devices))
                continue
            nh, nw = resized_shape((h, w), scale)
            hs = -(-nh // mesh.size)
            parts = []
            for i, d in enumerate(mesh.devices):
                if nw != w and (d, w, nw) not in self._wx:
                    self._wx[(d, w, nw)] = torch.as_tensor(_resize_weights(w, nw)[0], device=d)
                parts.append(_resize_rows(
                    self.fullf[d][k], scale, i * hs, hs, self._wx.get((d, w, nw)),
                ))
            out.append(all_gather_rows(RowShards(tuple(parts), nh, hs), mesh))
        return out


def prologue_shardable(rows: int, n_dev: int) -> bool:
    """Can a level image of `rows` rows live row-sharded over n_dev
    shards? Each shard must be at least KS rows deep (the halo of the
    first pass's 11x11 window) and hold a row of the image."""
    hs = -(-rows // n_dev)
    return hs >= KS and (n_dev - 1) * hs < rows


def _level_mesh(mesh: Mesh | None, lead, h1: int, h2: int) -> tuple[Mesh, bool]:
    """The mesh a level runs over and whether it is the run's: `mesh`
    when both images' level rows shard over it, else the lead alone."""
    if mesh is not None and prologue_shardable(h1, mesh.size) and prologue_shardable(h2, mesh.size):
        return mesh, True
    return Mesh((lead,)), False


def _first_pass_level(mesh: Mesh, img1: tuple, img2: tuple, fs: dict, scale: float, params):
    """first_pass over the slabs of `mesh`: img1's rows per slab (+- KS),
    img2 whole on every device (its table built once per device)."""
    threshold, min_stdev, _, _, cs = params
    h1 = img1[0].shape[0]
    hs = -(-h1 // mesh.size)
    tables: dict = {}
    parts = []
    for i, (dev, im1, im2) in enumerate(zip(mesh.devices, img1, img2)):
        if dev not in tables:
            tables[dev] = _first_pass_table(im2, min_stdev)
        r0 = i * hs
        parts.append(_first_pass_slab(
            _rows(im1, r0 - KS, r0 + hs + KS), tables[dev], fs[dev], scale,
            threshold, min_stdev, cs, r0, h1,
        ))
    return _sharded_state(parts, h1)


def _level_step(
    pair: _Pair, state_f, state_r, lv: _Level, params, win_f: int, win_r: int,
    first: bool, mesh: Mesh | None = None, exact: bool = False,
):
    """One pyramid level: forward and reverse passes, then both
    cross-checks, cross_check_exact's where `exact`
    (cybervision_tpu correlation._pyramid_level_body).

    The level runs over `mesh` when both images' rows pass
    prologue_shardable (else on the lead): resize, first pass or
    prologue, and cross-checks per row shard; a refine level's sweeps
    run as K1s when both directions' rows also pass shardable_rows,
    else as K1 on the lead. Takes the previous level's states as
    RowShards of any layout (unused by a first level) and returns the
    level's over the mesh it ran on, checked to span it. Appends to
    _LAST_PLAN whether the level and its sweeps ran sharded, and its
    windows."""
    h1 = resized_shape(pair.shapes[0], lv.scale)[0]
    h2 = resized_shape(pair.shapes[1], lv.scale)[0]
    m, sharded = _level_mesh(mesh, pair.lead, h1, h2)
    sweep = sharded and not first and (
        shardable_rows(h1, m.size, win_f) and shardable_rows(h2, m.size, win_r)
    )
    _LAST_PLAN["windows"].append(None if first else (win_f, win_r))
    _LAST_PLAN["sharded_prologue"].append(sharded)
    _LAST_PLAN["sharded_levels"].append(sweep)
    im1, im2 = pair.level_images(m, lv.scale)
    f_fwd, f_rev = pair.fs
    if first:
        state_f = _first_pass_level(m, im1, im2, f_fwd, lv.scale, params)
        state_r = _first_pass_level(m, im2, im1, f_rev, lv.scale, params)
    else:
        state_f = _level_direction(
            m, im1, im2, state_f, f_fwd, lv.scale, params, win_f, lv.wtr_f,
            lv.tmin_f, lv.ax_f, sweep,
        )
        state_r = _level_direction(
            m, im2, im1, state_r, f_rev, lv.scale, params, win_r, lv.wtr_r,
            lv.tmin_r, lv.ax_r, sweep,
        )
    state_f = _cross_check_level(m, state_f, state_r, lv.scale, exact)
    state_r = _cross_check_level(m, state_r, state_f, lv.scale, exact)
    if sharded:
        for t in (*state_f, *state_r):
            assert_spans_mesh(t, m)
    return state_f, state_r


def _reach_pair(pair: _Pair, state_f, state_r, lv: _Level, params, mesh) -> tuple[int, int]:
    """Both directions' maximum corridor reach at level lv from the
    previous level's states, computed over the mesh the level runs on and
    fetched to the host together."""
    _, _, min_range, extend_range, _ = params
    (h1, w1), (h2, w2) = (resized_shape(s, lv.scale) for s in pair.shapes)
    m, _ = _level_mesh(mesh, pair.lead, h1, h2)
    f_fwd, f_rev = pair.fs
    a = _reach(_corridors(m, state_f, f_fwd, h1, w1, h2, w2, lv.scale, min_range,
                          extend_range, lv.fv_f), h1)
    b = _reach(_corridors(m, state_r, f_rev, h2, w2, h1, w1, lv.scale, min_range,
                          extend_range, lv.fv_r), h2)
    ra, rb = torch.stack([a, b.to(a.device)]).tolist()
    return int(ra), int(rb)


# The last correlate_images run's plan: whether it had a mesh, and per
# level in run order whether it ran row-sharded over it from resize to
# cross-check (sharded_prologue), whether its sweeps ran as K1s
# (sharded_levels; the JAX package's _LAST_PLAN["pallas_levels"]; a first
# level has no K1 sweep) and their (forward, reverse) windows (None for
# the first pass).
_LAST_PLAN: dict = {"mesh": False, "sharded_levels": [], "sharded_prologue": [], "windows": []}


def _bucket(max_len: int, cfg: CorrelationConfig) -> int:
    """Smallest window bucket covering the observed maximum."""
    for b in cfg.corridor_window_buckets:
        if b >= max_len:
            return b
    return cfg.corridor_window_buckets[-1]


def correlate_images(
    src1,
    src2,
    f: np.ndarray,
    projection: ProjectionMode,
    cfg: CorrelationConfig = CorrelationConfig(),
    progress=None,
    device_out: bool | str = False,
    device: torch.device | str = "cuda",
    mesh=AUTO,
):
    """Coarse-to-fine correlation of an image pair (reconstruction.rs:
    528-588 + correlation/mod.rs:217-245). src1, src2: objects with a
    uint8 (H, W) `.img`.

    device_out=False returns the (H1, W1, 3) int64 numpy (x2, y2, valid)
    grid; True the same planes as an int32 tensor (pack_state); "word"
    the compact (H, W) int32 tensor; "delta" the (d16, word) pair of
    pack_state_delta — each tensor left on `device`.

    mesh: a parallel.Mesh to shard the levels over, None for one device,
    or AUTO to read parallel.pipeline_mesh() once. Under a mesh `device`
    is its lead device, which receives the final state. _LAST_PLAN
    records the run's plan.
    """
    mesh = resolve_mesh(mesh, device)
    device = torch.device(device) if mesh is None else mesh.lead
    global _LAST_PLAN
    _LAST_PLAN = {"mesh": mesh is not None, "sharded_levels": [],
                  "sharded_prologue": [], "windows": []}
    threshold = cfg.threshold(projection)
    min_stdev = cfg.min_stdev(projection)
    cs = cfg.corridor_size(projection)
    params = (
        threshold, min_stdev, cfg.corridor_min_range(projection),
        cfg.corridor_extend_range(projection), cs,
    )
    shape1 = tuple(src1.img.shape)
    shape2 = tuple(src2.img.shape)
    h1, w1 = shape1
    scales = pyramid_scales((w1, h1), cfg.scale_min_size)
    f = normalize_f(f)
    pair = _Pair(mesh.devices if mesh is not None else (device,), src1.img, src2.img, f)
    levels = [_plan_level(f, s, shape1, shape2) for s in scales]
    state_f = state_r = None

    if cfg.corridor_window_fixed is not None:
        win = cfg.corridor_window_fixed
        split = len(scales) > 1 and cfg.corridor_window_escalate
        coarse = levels[:-1] if split else levels
        coarse_reach = 0
        for si, lv in enumerate(coarse):
            if si > 0 and split:
                coarse_reach = max(coarse_reach, *_reach_pair(
                    pair, state_f, state_r, lv, params, mesh
                ))
            state_f, state_r = _level_step(
                pair, state_f, state_r, lv, params, win, win, first=si == 0,
                mesh=mesh, exact=cfg.exact_cross_check,
            )
        if split:
            if coarse_reach > win:
                # A coarse level already truncated: rerun fully
                # data-driven (the cost doubles, so say so).
                print(
                    "Corridor reach exceeded the fixed window"
                    f" ({coarse_reach} > {win}); escalating to"
                    " data-driven windows (pyramid rerun)",
                    file=sys.stderr,
                )
                nested = progress
                if progress is not None:
                    progress.report_status(0.5)
                    nested = _BandProgress(progress, 0.5, 1.0)
                return correlate_images(
                    src1, src2, f, projection,
                    dataclasses.replace(cfg, corridor_window_fixed=None),
                    nested, device_out, device, mesh,
                )
            fin = levels[-1]
            reach_f, reach_r = _reach_pair(pair, state_f, state_r, fin, params, mesh)
            state_f, state_r = _level_step(
                pair, state_f, state_r, fin, params,
                max(win, _bucket(reach_f, cfg)), max(win, _bucket(reach_r, cfg)),
                first=False, mesh=mesh, exact=cfg.exact_cross_check,
            )
        if progress is not None:
            progress.report_status(1.0)
        return _finish_correlate(gather_state(state_f, device), shape1, shape2, device_out)

    total = sum(s * s for s in scales)
    done = 0.0
    for si, lv in enumerate(levels):
        win_f = win_r = 16
        if si > 0:
            win_f, win_r = (
                _bucket(r, cfg) for r in _reach_pair(pair, state_f, state_r, lv, params, mesh)
            )
        state_f, state_r = _level_step(
            pair, state_f, state_r, lv, params, win_f, win_r, first=si == 0,
            mesh=mesh, exact=cfg.exact_cross_check,
        )
        done += lv.scale * lv.scale
        if progress is not None:
            progress.report_status(done / total)
    return _finish_correlate(gather_state(state_f, device), shape1, shape2, device_out)


def _finish_correlate(state_f, shape1, shape2, device_out):
    if device_out == "word":
        return pack_state_compact(state_f)
    if device_out == "delta":
        return pack_state_delta(state_f)
    if device_out:
        return pack_state(state_f)
    if max(*shape1, *shape2) > 4096:
        return pack_state(state_f).cpu().numpy().astype(np.int64)
    return unpack_correlated(pack_state_compact(state_f).cpu().numpy())


def sample_word_grid(word_dev: torch.Tensor, k: int, seed: int):
    """--max-points subsample on the word grid's device (the JAX
    package's sample_word_grid): every valid pixel of the compact (H, W)
    int32 word scores jax.random.uniform(PRNGKey(seed)) at its flat
    index (utils.prng.uniform, bit-exact), every invalid one -1.0, and
    the first k of a stable sort of the negated scores are taken — the
    order of jnp.argsort(-scores), whose ties (the invalid pixels when
    fewer than k are valid) keep index order. Returns the flat int32
    indices and their words as numpy; entries beyond the valid count
    have the valid bit clear."""
    from cybervision_tpu_torch.utils import prng

    flat = word_dev.reshape(-1)
    scores = prng.uniform(prng.prng_key(seed), flat.shape, flat.device)
    scores = torch.where(((flat >> 24) & 1) == 1, scores, -1.0)
    idx = torch.sort(-scores, stable=True).indices[:k]
    return idx.to(I32).cpu().numpy(), flat[idx].cpu().numpy()


def unpack_correlated(arr: np.ndarray) -> np.ndarray:
    """Host tail for a fetched device_out result: a compact (H, W) int32
    word -> (H, W, 3) int64 (x2, y2, valid); (H, W, 3) planes pass
    through as int64."""
    if arr.ndim == 3:
        return arr.astype(np.int64)
    packed = np.empty((*arr.shape, 3), np.int64)
    packed[:, :, 0] = arr & 0xFFF
    packed[:, :, 1] = (arr >> 12) & 0xFFF
    packed[:, :, 2] = (arr >> 24) & 1
    return packed


def pack_state(state: CorrelationState) -> torch.Tensor:
    """(H, W, 3) int32 = (x2, y2, valid): the planes of the PNG fast
    lane, and of the host grid above 4096 px."""
    return torch.cat([state.pos, state.valid[:, :, None].to(I32)], dim=2)


def pack_state_compact(state: CorrelationState) -> torch.Tensor:
    """(H, W) int32 = x2 | y2 << 12 | valid << 24 (coords < 4096)."""
    return (
        (state.pos[:, :, 0] & 0xFFF)
        | ((state.pos[:, :, 1] & 0xFFF) << 12)
        | (state.valid.to(I32) << 24)
    )


def pack_state_delta(state: CorrelationState):
    """Delta plane + compact word: (d16 (H, W) int32 holding uint16 bit
    patterns, word (H, W) int32).

    d16 packs per-pixel position deltas dx = x2 - x, dy = y2 - y, each
    biased into 7 bits ([-64, 63]), the valid bit at bit 14, and in
    EVERY element bit 15 = the overflow flag (some valid pixel's delta
    falls outside [-64, 63]); the host then writes from the word plane
    instead. Invalid pixels may wrap — consumers check the valid bit."""
    word = pack_state_compact(state)
    dev = state.pos.device
    col = torch.arange(state.pos.shape[1], dtype=I32, device=dev)[None, :]
    row = torch.arange(state.pos.shape[0], dtype=I32, device=dev)[:, None]
    dx = state.pos[:, :, 0] - col
    dy = state.pos[:, :, 1] - row
    over = torch.any(
        state.valid & ((dx < -64) | (dx > 63) | (dy < -64) | (dy > 63))
    )
    d16 = (
        ((dx + 64) & 0x7F)
        | (((dy + 64) & 0x7F) << 7)
        | (state.valid.to(I32) << 14)
        | (over.to(I32) << 15)
    )
    return d16, word


def unpack_delta_grid(d16: np.ndarray) -> np.ndarray:
    """Host inverse of pack_state_delta's d16 plane -> compact int32 word.
    Only meaningful when the overflow flag (bit 15) is clear."""
    p = d16.astype(np.int32)
    dx = (p & 0x7F) - 64
    dy = ((p >> 7) & 0x7F) - 64
    v = (p >> 14) & 1
    col = np.arange(d16.shape[1], dtype=np.int32)[None, :]
    row = np.arange(d16.shape[0], dtype=np.int32)[:, None]
    return ((col + dx) & 0xFFF) | (((row + dy) & 0xFFF) << 12) | (v << 24)
