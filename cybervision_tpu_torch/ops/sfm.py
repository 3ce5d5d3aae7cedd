"""Incremental perspective structure-from-motion (counterpart of
cybervision_tpu/ops/sfm.py: its host numpy code copied, with the device
work on the run's torch device — P3P scoring and the large DLT eigh in
ops.sfm_device, bundle adjustment in ops.ba — and the native track merge
from this package's native library).

Reference (triangulation.rs:605-1593): tracks are per-image optional 2D
points plus an optional 3D point; the sparse phase picks the best initial
pair by cheirality count from E = K2' F K1; remaining cameras are
recovered by P3P (Nakano BMVC2019) inside RANSAC; points triangulate by
multi-view DLT; dense pairs extend tracks by nearest-correlation lookup;
per-image track merging averages nearby tracks; outliers drop on
cheirality and minimum ray angle; bundle adjustment refines.

TPU/array redesign:
  * tracks are padded (T, n_images, 2) int32 arrays (-1 = missing)
  * DLT triangulation runs batched on device: per-track 4x4 normal
    matrices + eigh nullspace instead of per-track SVD loops
  * track extension uses a distance transform (nearest valid correlated
    point for every pixel at once) instead of per-track window scans
  * track merging is scatter-adds + box sums over per-pixel accumulators
  * P3P candidates solve vectorized in f64 on the host (tiny closed-form
    math; TPUs lack f64) and score batched on device

Deviations (documented):
  * RANSAC pose scoring reprojects the tracks' existing 3D points through
    the candidate camera instead of re-triangulating every track per
    candidate (triangulation.rs:1309-1328) — same accept/reject contract
    at the reference's loose 0.05*max_dim threshold, removes a DLT from
    the inner loop.
  * extend_tracks picks the euclidean-nearest correlated point within the
    search radius for all tracks at once (distance transform); the
    reference scans a Chebyshev box and breaks ties by scan order
    (triangulation.rs:1362-1383).
  * the quartic solver takes real cube roots (np.cbrt) where the
    reference's r.powf(1/3) / q.powf(1/3) return NaN for negative bases
    (triangulation.rs:1620-1626) and silently discard every root of that
    P3P sample — this implementation keeps the mathematically-real roots
    (Newton polishing + the RANSAC gates still reject bad poses).
  * extend_tracks consumes the matched image-1 grid CELL so it can't also
    spawn a new track; the reference clears its (image-1-indexed)
    remaining grid at the match's image-2 COORDINATES
    (triangulation.rs:1392-1394), which both duplicates the matched cell
    into a fresh track and suppresses an unrelated cell.
  * merge_tracks computes true coordinate averages; the reference's
    AverageTrack::add_track/add_average_track accumulate into a
    freshly-None'd vector each call (triangulation.rs:524, 554-557), so
    its "averages" degenerate to the last-scanned track's points.
  * bundle adjustment applies the LM DESCENT step (theta -= delta with
    gradient J'r, r = projected - original); the reference applies
    theta += delta for the same conventions (triangulation.rs:2017,
    469-470) — an ascent step, so every upstream LM iteration is
    rejected and its BA returns the input cameras unchanged. See ops.ba.
"""

from __future__ import annotations

import numpy as np

from cybervision_tpu_torch import native
from cybervision_tpu_torch.config import ReconstructionConfig, TriangulationConfig
from cybervision_tpu_torch.ops import sfm_device
from cybervision_tpu_torch.ops.surface import MISSING, Camera, Surface
from cybervision_tpu_torch.ops import ba
from cybervision_tpu_torch.utils.progress import DetailTimer, PhaseTimer

# ---------------------------------------------------------------------------
# Track store


class TrackStore:
    """Growable padded track arrays."""

    def __init__(self, n_images: int):
        self.n_images = n_images
        self.pts = np.zeros((0, n_images, 2), np.int32)
        self.points3d = np.zeros((0, 3), np.float64)
        self.has_point3d = np.zeros((0,), bool)

    def __len__(self):
        return len(self.pts)

    def append(self, pts: np.ndarray):
        n = len(pts)
        self.pts = np.concatenate([self.pts, pts.astype(np.int32)])
        self.points3d = np.concatenate([self.points3d, np.zeros((n, 3))])
        self.has_point3d = np.concatenate([self.has_point3d, np.zeros(n, bool)])

    def visible(self, image_i: int) -> np.ndarray:
        return self.pts[:, image_i, 0] != MISSING


# ---------------------------------------------------------------------------
# Multi-view DLT triangulation (batched)


def dlt_normals(
    pts: np.ndarray, projections: list[np.ndarray | None]
) -> tuple[np.ndarray, np.ndarray]:
    """Per-track DLT normal matrices sum r r' over the 2 rows per view
    (x*P3 - P1, y*P3 - P2), rows normalized for conditioning, and each
    track's view count. pts: (T, n_images, 2) int32 with MISSING;
    projections: list of (3,4) or None. Returns ((T, 4, 4) f64, (T,))."""
    t = len(pts)
    ata = np.zeros((t, 4, 4))
    n_views = np.zeros(t, np.int32)
    for i, p in enumerate(projections):
        if p is None:
            continue
        vis = pts[:, i, 0] != MISSING
        if not vis.any():
            continue
        xy = pts[vis, i].astype(np.float64)
        r1 = xy[:, 0:1] * p[2][None, :] - p[0][None, :]  # (V, 4)
        r2 = xy[:, 1:2] * p[2][None, :] - p[1][None, :]
        for r in (r1, r2):
            norm = np.linalg.norm(r, axis=1, keepdims=True)
            r = r / np.maximum(norm, 1e-12)
            ata[vis] += r[:, :, None] * r[:, None, :]
        n_views[vis] += 1
    return ata, n_views


def triangulate_tracks_np(
    pts: np.ndarray, projections: list[np.ndarray | None],
    scale_threshold: float = 1e-4, device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Batched DLT (triangulation.rs:866-911), the eigh on `device`
    (sfm_device.dlt_nullspaces).

    pts: (T, n_images, 2) int32 with MISSING; projections: list of (3,4)
    or None. Returns (points3d (T,3) f64, valid (T,)). The homogeneous
    point is the smallest eigenvector of the track's dlt_normals matrix.
    """
    t = len(pts)
    if t == 0:
        return np.zeros((0, 3)), np.zeros((0,), bool)
    ata, n_views = dlt_normals(pts, projections)
    solvable = n_views >= 2
    idx = np.nonzero(solvable)[0]
    points = np.zeros((t, 3))
    valid = np.zeros(t, bool)
    if len(idx) == 0:
        return points, valid
    # Smallest eigenvector of each normal matrix: a float32 eigh on the
    # device + a float64 host polish at every batch size. The JAX package
    # takes a host float64 eigh below 32,768 tracks (the TPU's dispatch
    # cost); on the H100 the device path is the faster one at every size
    # the perspective runs give, 460 to 283,467 tracks (PERF.md,
    # chip_smoke.py's check_dlt_paths).
    h = sfm_device.dlt_nullspaces(ata[idx], device)
    wcomp = h[:, 3]
    ok = np.abs(wcomp) >= scale_threshold
    pts3 = h[:, :3] / np.where(ok, wcomp, 1.0)[:, None]
    points[idx] = pts3
    valid[idx] = ok
    return points, valid


# ---------------------------------------------------------------------------
# Essential-matrix bootstrap (triangulation.rs:940-994)


def find_projection_matrix(
    f: np.ndarray, k1: np.ndarray, k2: np.ndarray, pts_pair: np.ndarray, device="cuda"
) -> tuple[np.ndarray, float] | None:
    """Decompose E = K2' F K1 into the 4 (R, t) candidates and pick the
    one with the most triangulated points in front of both cameras.
    pts_pair: (M, 2, 2) image-1/image-2 points. Returns ((3,4) [R|t],
    cheirality count)."""
    e = k2.T @ f @ k1
    u, s, vt = np.linalg.svd(e)
    e = u @ np.diag([1.0, 1.0, 0.0]) @ vt
    u, s, vt = np.linalg.svd(e)
    w = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    r1 *= np.sign(np.linalg.det(r1))
    r2 *= np.sign(np.linalg.det(r2))
    u3 = u[:, 2]

    p1 = k1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
    m = len(pts_pair)
    tracks = np.full((m, 2, 2), MISSING, np.int32)
    tracks[:, 0] = pts_pair[:, 0]
    tracks[:, 1] = pts_pair[:, 1]

    best = None
    for r, t in [(r1, u3), (r1, -u3), (r2, u3), (r2, -u3)]:
        p2 = np.hstack([r, t[:, None]])
        cam2 = Camera.from_matrix(k2, r, t)
        pts3, ok = triangulate_tracks_np(tracks, [p1, k2 @ p2], device=device)
        in_front = ok & (pts3[:, 2] > 0) & cam2.point_in_front(pts3)
        count = int(in_front.sum())
        # >= : Iterator::max_by keeps the LAST of equal maxima
        # (triangulation.rs:992), so tied cheirality counts must select
        # the later (R, t) candidate or the bootstrap pair diverges.
        if best is None or count >= best[1]:
            best = (p2, count)
    if best is None:
        return None
    return best


# ---------------------------------------------------------------------------
# P3P (Nakano BMVC2019) — vectorized host solve (triangulation.rs:1146-1278)


def solve_p3p(bearings: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Batched P3P: bearings (B, 3, 3) unit rays (camera frame), points
    (B, 3, 3) world points. Returns (B, 4, 12): up to 4 candidate [R|t]
    flattened (r00..r22, t0..t2), NaN where invalid.

    Follows the reference's Nakano formulation: orthonormal world frame
    from the three points, a quartic in x = d2/d1, Newton polishing of
    (x, y) on the f/g system, then closed-form R, t.
    """
    b = len(bearings)
    out = np.full((b, 4, 12), np.nan)
    if b == 0:
        return out

    # Reorder so points 0-1 are the farthest apart (triangulation.rs:1162-1172).
    d01 = np.linalg.norm(points[:, 0] - points[:, 1], axis=1)
    d12 = np.linalg.norm(points[:, 1] - points[:, 2], axis=1)
    d02 = np.linalg.norm(points[:, 0] - points[:, 2], axis=1)
    rot1 = (d12 > d01) & (d12 > d02)  # rotate left: 1,2,0
    swap12 = (d02 > d01) & (d02 > d12) & ~rot1  # swap 1 and 2

    idx = np.tile(np.arange(3), (b, 1))
    idx[rot1] = [1, 2, 0]
    idx[swap12] = [0, 2, 1]
    bi = np.take_along_axis(bearings, idx[:, :, None], axis=1)
    pi = np.take_along_axis(points, idx[:, :, None], axis=1)

    with np.errstate(all="ignore"):  # degenerate samples propagate NaN
        x10 = pi[:, 1] - pi[:, 0]
        x20 = pi[:, 2] - pi[:, 0]
        nx = x10 / np.linalg.norm(x10, axis=1, keepdims=True)
        nz = np.cross(nx, x20)
        nz /= np.linalg.norm(nz, axis=1, keepdims=True)
        ny = np.cross(nz, nx)

    a = np.einsum("bi,bi->b", nx, x10)
    bb = np.einsum("bi,bi->b", nx, x20)
    c = np.einsum("bi,bi->b", ny, x20)

    m01 = np.einsum("bi,bi->b", bi[:, 0], bi[:, 1])
    m02 = np.einsum("bi,bi->b", bi[:, 0], bi[:, 2])
    m12 = np.einsum("bi,bi->b", bi[:, 1], bi[:, 2])

    p = bb / a
    q = (bb * bb + c * c) / (a * a)

    f = np.stack(
        [p, -m12, np.zeros(b), -m01 * (2.0 * p - 1.0), m02, p - 1.0], axis=1
    )
    g = np.stack(
        [q, np.zeros(b), -np.ones(b), -2.0 * m01 * q, 2.0 * m02, q - 1.0], axis=1
    )

    h = np.stack(
        [
            -f[:, 0] ** 2 + g[:, 0] * f[:, 1] ** 2,
            f[:, 1] ** 2 * g[:, 3]
            - 2.0 * f[:, 0] * f[:, 3]
            - 2.0 * f[:, 0] * f[:, 1] * f[:, 4]
            + 2.0 * f[:, 1] * f[:, 4] * g[:, 0],
            f[:, 4] ** 2 * g[:, 0]
            - 2.0 * f[:, 0] * f[:, 4] ** 2
            - 2.0 * f[:, 0] * f[:, 5]
            + f[:, 1] ** 2 * g[:, 5]
            - f[:, 3] ** 2
            - 2.0 * f[:, 1] * f[:, 3] * f[:, 4]
            + 2.0 * f[:, 1] * f[:, 4] * g[:, 3],
            f[:, 4] ** 2 * g[:, 3]
            - 2.0 * f[:, 3] * f[:, 4] ** 2
            - 2.0 * f[:, 3] * f[:, 5]
            - 2.0 * f[:, 1] * f[:, 4] * f[:, 5]
            + 2.0 * f[:, 1] * f[:, 4] * g[:, 5],
            -2.0 * f[:, 4] ** 2 * f[:, 5] + g[:, 5] * f[:, 4] ** 2 - f[:, 5] ** 2,
        ],
        axis=1,
    )

    xs = _solve_quartic_np(h)  # (B, 4)
    with np.errstate(all="ignore"):
        ys = -((f[:, 0:1] * xs + f[:, 3:4]) * xs + f[:, 5:6]) / (
            f[:, 4:5] + f[:, 1:2] * xs
        )
        xs, ys = _polish_roots_np(f, g, xs, ys)

    # Rotation/translation assembly (triangulation.rs:1227-1277).
    a_mat = np.zeros((b, 3, 3))
    a_mat[:, :, 0] = -bi[:, 0]
    a_mat[:, :, 1] = bi[:, 1]
    b_mat = np.zeros((b, 3, 3))
    b_mat[:, :, 0] = -bi[:, 0]
    b_mat[:, :, 2] = bi[:, 2]
    c_mat = b_mat - p[:, None, None] * a_mat
    n = np.stack([nx, ny, nz], axis=2)  # columns

    for root in range(4):
        x = xs[:, root]
        y = ys[:, root]
        fin = np.isfinite(x) & np.isfinite(y)
        if not fin.any():
            continue
        lam = np.stack([np.ones(b), x, y], axis=1)
        av = np.einsum("bij,bj->bi", a_mat, lam)
        s = np.linalg.norm(av, axis=1) / a
        with np.errstate(all="ignore"):
            d = lam / s[:, None]
            r1v = np.einsum("bij,bj->bi", a_mat, d) / a[:, None]
            r2v = np.einsum("bij,bj->bi", c_mat, d) / c[:, None]
            r3v = np.cross(r1v, r2v)
            rc = np.stack([r1v, r2v, r3v], axis=2)
            tc = d[:, 0:1] * bi[:, 0]
            r = np.einsum("bij,bkj->bik", rc, n)
            t = tc - np.einsum("bij,bj->bi", r, pi[:, 0])
        okr = fin & np.isfinite(r).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
        flat = np.concatenate([r.reshape(b, 9), t], axis=1)
        out[:, root] = np.where(okr[:, None], flat, np.nan)
    return out


def _solve_quartic_np(h: np.ndarray) -> np.ndarray:
    """Batched closed-form quartic roots (triangulation.rs:1595-1634);
    returns (B, 4), NaN for complex roots."""
    with np.errstate(all="ignore"):
        a, b, c, d, e = h[:, 0], h[:, 1], h[:, 2], h[:, 3], h[:, 4]
        alpha = -3.0 * b * b / (8.0 * a * a) + c / a
        beta = b**3 / (8.0 * a**3) - b * c / (2.0 * a * a) + d / a
        gamma = (
            -3.0 * b**4 / (256.0 * a**4)
            + b * b * c / (16.0 * a**3)
            - b * d / (4.0 * a * a)
            + e / a
        )
        p = -alpha * alpha / 12.0 - gamma
        q = -(alpha**3) / 108.0 + alpha * gamma / 3.0 - beta * beta / 8.0
        r = -q / 2.0 + np.sqrt(q * q / 4.0 + p**3 / 27.0)
        u = np.cbrt(r)
        y = np.where(
            np.abs(u) < np.finfo(np.float64).eps,
            -5.0 * alpha / 6.0 - np.cbrt(q),
            -5.0 * alpha / 6.0 - p / (3.0 * u) + u,
        )
        w = np.sqrt(alpha + 2.0 * y)
        shift = -b / (4.0 * a)
        s1 = np.sqrt(-(3.0 * alpha + 2.0 * y + 2.0 * beta / w))
        s2 = np.sqrt(-(3.0 * alpha + 2.0 * y - 2.0 * beta / w))
        roots = np.stack(
            [
                shift + 0.5 * (w + s1),
                shift + 0.5 * (w - s1),
                shift + 0.5 * (-w + s2),
                shift + 0.5 * (-w - s2),
            ],
            axis=1,
        )
    return roots


def _polish_roots_np(f, g, xs, ys, iters: int = 5):
    """Newton polishing on the f/g polynomial system
    (triangulation.rs:1636-1673), batched with NaN-safe math."""
    with np.errstate(all="ignore"):
        for _ in range(iters):
            x, y = xs, ys
            fv = (
                f[:, 0:1] * x * x + f[:, 1:2] * x * y + f[:, 3:4] * x
                + f[:, 4:5] * y + f[:, 5:6]
            )
            gv = g[:, 0:1] * x * x - y * y + g[:, 3:4] * x + g[:, 4:5] * y + g[:, 5:6]
            dfdx = 2.0 * f[:, 0:1] * x + f[:, 1:2] * y + f[:, 3:4]
            dfdy = f[:, 1:2] * x + f[:, 4:5]
            dgdx = 2.0 * g[:, 0:1] * x + g[:, 3:4]
            dgdy = -2.0 * y + g[:, 4:5]
            inv_det = 1.0 / (dfdx * dgdy - dfdy * dgdx)
            dx = (dgdy * fv - dfdy * gv) * inv_det
            dy = (-dgdx * fv + dfdx * gv) * inv_det
            upd = np.isfinite(dx) & np.isfinite(dy)
            xs = np.where(upd, x - dx, x)
            ys = np.where(upd, y - dy, y)
    return xs, ys


def recover_pose_ransac(
    pts2d: np.ndarray,
    pts3d: np.ndarray,
    const_err: np.ndarray,
    k: np.ndarray,
    max_dimension: int,
    cfg: TriangulationConfig,
    rng: np.random.RandomState,
    device="cuda",
    mesh=None,
) -> Camera | None:
    """P3P RANSAC (triangulation.rs:1033-1144), candidates scored on
    `device`, or over the shards of `mesh` (sfm_device.p3p_score).

    pts2d: (T, 2) this image's observations of the linked tracks;
    pts3d: (T, 3) their triangulated points; const_err: (T,) the max
    reprojection error over already-recovered cameras (hypothesis-
    independent under fixed points — see module docstring).
    """
    t = len(pts2d)
    if t < cfg.ransac_n:
        return None
    k_inv = np.linalg.pinv(k)
    h2d = np.concatenate([pts2d.astype(np.float64), np.ones((t, 1))], axis=1)
    rays = h2d @ k_inv.T
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)

    inlier_t = cfg.ransac_inliers_t * max_dimension
    points_t = cfg.ransac_t * max_dimension
    ransac_d = cfg.ransac_d_percent * t // 100
    d_early = cfg.ransac_d_percent_early_exit * t // 100

    best = (None, 0, np.inf)
    n_rounds = max(1, cfg.ransac_k // cfg.check_interval)
    for _ in range(n_rounds):
        bsz = cfg.check_interval
        sample = rng.randint(0, t, (bsz, 3))
        cands = solve_p3p(rays[sample], pts3d[sample])  # (B, 4, 12)
        cands = cands.reshape(-1, 12)
        sample_rep = np.repeat(sample, 4, axis=0)

        # Projection P = K [R|t] per candidate; NaN candidates stay NaN
        # and are rejected by the device scorer's finite checks.
        r = cands[:, :9].reshape(-1, 3, 3)
        tv = cands[:, 9:12]
        with np.errstate(all="ignore"):
            proj = np.einsum(
                "ij,bjk->bik", k, np.concatenate([r, tv[:, :, None]], axis=2)
            )

        # Device-batched scoring: sample-consistency gate
        # (triangulation.rs:1110-1117) + reprojection sweep over all
        # linked tracks, chunked on the hypothesis axis (ops.sfm_device).
        counts, maxerrs, ok = sfm_device.p3p_score(
            proj,
            pts2d[sample_rep],
            pts3d[sample_rep],
            pts3d,
            pts2d,
            const_err,
            inlier_t,
            points_t,
            device=device,
            mesh=mesh,
        )
        counts = np.where(ok, counts, 0)
        if not counts.any():
            continue
        # Reference ordering (reduce_best_result, triangulation.rs:
        # 1078-1083): count descending, then error ascending, where the
        # error statistic is max-inlier-error / count (rs:1128).
        cmax = int(counts.max())
        tied = np.nonzero(counts == cmax)[0]
        errs = maxerrs[tied] / cmax
        bi = int(tied[np.argmin(errs)])
        cand_err = float(errs.min())
        if cmax > best[1] or (cmax == best[1] and cand_err < best[2]):
            best = ((r[bi], tv[bi]), cmax, cand_err)
        if best[1] >= d_early:
            break

    if best[0] is None or best[1] <= ransac_d:
        return None
    r, tv = best[0]
    return Camera.from_matrix(k, r, tv)


# ---------------------------------------------------------------------------
# Track extension / merging


def extend_tracks(
    store: TrackStore,
    image1_i: int,
    image2_i: int,
    correlated: np.ndarray,
    search_radius: int,
) -> None:
    """Attach correlated points to existing tracks; leftovers become new
    tracks (triangulation.rs:1330-1419). correlated: (H, W, 3) int array
    of (x2, y2, valid)."""
    valid = correlated[:, :, 2] == 1
    h, w = valid.shape

    used = np.zeros((h, w), bool)
    has1 = store.visible(image1_i)
    no2 = store.pts[:, image2_i, 0] == MISSING
    cand = np.nonzero(has1)[0]
    r = int(search_radius)
    if len(cand) and valid.any() and r > 0:
        # The reference scans the ASYMMETRIC Chebyshev box
        # [p-r, p+r) x [p-r, p+r) row-major and keeps the first valid
        # cell of minimum squared euclidean distance, with NO distance
        # cap (triangulation.rs:1362-1383: `distance < min_distance`
        # keeps the first minimum in y-then-x scan order) — box-corner
        # cells at euclidean distance >= r still attach. Vectorized as a
        # per-track window gather in that exact scan order so
        # np.argmin's first-minimum rule reproduces the tie-break.
        offs_y, offs_x = np.mgrid[-r:r, -r:r]
        offs_y = offs_y.ravel()
        offs_x = offs_x.ravel()
        d2 = offs_y.astype(np.int64) ** 2 + offs_x.astype(np.int64) ** 2
        big = np.int64(1) << 62
        k = len(d2)
        chunk = max(1, (1 << 24) // k)
        for lo in range(0, len(cand), chunk):
            rows = cand[lo : lo + chunk]
            px = store.pts[rows, image1_i, 0].astype(np.int64)
            py = store.pts[rows, image1_i, 1].astype(np.int64)
            yy = py[:, None] + offs_y[None, :]
            xx = px[:, None] + offs_x[None, :]
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = np.zeros(inb.shape, bool)
            v[inb] = valid[yy[inb], xx[inb]]
            key = np.where(v, d2[None, :], big)
            j = np.argmin(key, axis=1)
            ar = np.arange(len(rows))
            found = key[ar, j] < big
            src_y = yy[ar, j][found]
            src_x = xx[ar, j][found]
            tgt = correlated[src_y, src_x, :2]
            frows = rows[found]
            add = no2[frows]
            store.pts[frows[add], image2_i, 0] = tgt[add, 0]
            store.pts[frows[add], image2_i, 1] = tgt[add, 1]
            used[src_y, src_x] = True

    rest = valid & ~used
    ys, xs = np.nonzero(rest)
    if len(ys):
        new = np.full((len(ys), store.n_images, 2), MISSING, np.int32)
        new[:, image1_i, 0] = xs
        new[:, image1_i, 1] = ys
        new[:, image2_i, 0] = correlated[ys, xs, 0]
        new[:, image2_i, 1] = correlated[ys, xs, 1]
        store.append(new)


def merge_tracks(
    store: TrackStore,
    image_i: int,
    shape: tuple[int, int],
    cfg: TriangulationConfig,
) -> TrackStore:
    """Collapse tracks sharing (a neighborhood of) an image_i pixel into
    averaged tracks (triangulation.rs:1421-1539).

    Per pixel: the area-average track over a +-r window must be within
    max_distance of every member track on every shared image, else the
    pixel's tracks are dropped; the merged track is the plain average of
    the exact-pixel members.
    """
    w, h = shape
    max_dim = max(w, h)
    denom = cfg.tracks_radius_denominator
    r = (
        cfg.merge_tracks_search_radius * max_dim // denom
        if max_dim > denom
        else cfg.merge_tracks_search_radius
    )
    max_d2 = (
        cfg.merge_tracks_max_distance**2 * max_dim // denom
        if max_dim > denom
        else cfg.merge_tracks_max_distance**2
    )

    # Native single-sweep pass (native.cpp merge_tracks_image) when the
    # library builds: _merge_tracks_numpy below is its semantic oracle
    # (tests/test_torch_sfm.py holds both lanes to the JAX package).
    if native.available():
        out = TrackStore(store.n_images)
        merged = native.merge_tracks_image(
            store.pts, image_i, w, h, int(r), int(max_d2)
        )
        if len(merged):
            out.append(merged)
        return out
    return _merge_tracks_numpy(store, image_i, (w, h), int(r), int(max_d2))


def _merge_tracks_numpy(
    store: TrackStore,
    image_i: int,
    shape: tuple[int, int],
    r: int,
    max_d2: int,
) -> TrackStore:
    """The numpy form of the merge — fallback and native oracle."""
    w, h = shape
    vis_i = store.visible(image_i)
    if not vis_i.any():
        out = TrackStore(store.n_images)
        return out
    rows = np.nonzero(vis_i)[0]
    px = np.clip(store.pts[rows, image_i, 0], 0, w - 1)
    py = np.clip(store.pts[rows, image_i, 1], 0, h - 1)

    n_img = store.n_images
    # Per-pixel accumulators per image: sum_x, sum_y, count. bincount
    # over flattened pixel ids instead of np.add.at — ufunc.at takes a
    # slow per-element path (~20x at the multi-view track counts where
    # this runs once per image merge).
    flat = py * w + px
    sum_x = np.zeros((n_img, h, w))
    sum_y = np.zeros((n_img, h, w))
    count = np.zeros((n_img, h, w))
    for m in range(n_img):
        vm = store.pts[rows, m, 0] != MISSING
        fm = flat[vm]
        sum_x[m] = np.bincount(
            fm, weights=store.pts[rows[vm], m, 0], minlength=h * w
        ).reshape(h, w)
        sum_y[m] = np.bincount(
            fm, weights=store.pts[rows[vm], m, 1], minlength=h * w
        ).reshape(h, w)
        count[m] = np.bincount(fm, minlength=h * w).reshape(h, w)

    # Area aggregates over the asymmetric [p-r, p+r) window
    # (saturating_sub/min semantics, triangulation.rs:1469-1510).
    def box(acc):
        c = np.cumsum(acc, axis=1)
        c = np.concatenate([np.zeros_like(c[:, :1]), c], axis=1)
        hi = np.minimum(np.arange(h) + r, h)
        lo = np.maximum(np.arange(h) - r, 0)
        acc = c[:, hi] - c[:, lo]
        c = np.cumsum(acc, axis=2)
        c = np.concatenate([np.zeros_like(c[:, :, :1]), c], axis=2)
        hi = np.minimum(np.arange(w) + r, w)
        lo = np.maximum(np.arange(w) - r, 0)
        return c[:, :, hi] - c[:, :, lo]

    a_sum_x = box(sum_x)
    a_sum_y = box(sum_y)
    a_count = box(count)

    with np.errstate(all="ignore"):
        # Integer-average like the reference's u64 division
        # (triangulation.rs:585-597).
        area_x = np.floor(a_sum_x / np.maximum(a_count, 1.0))
        area_y = np.floor(a_sum_y / np.maximum(a_count, 1.0))

    # can_merge: every member track vs the area average at its pixel.
    can = np.ones(len(rows), bool)
    for m in range(n_img):
        vm = store.pts[rows, m, 0] != MISSING
        am = a_count[m, py, px] > 0
        both = vm & am
        dx = store.pts[rows, m, 0] - area_x[m, py, px]
        dy = store.pts[rows, m, 1] - area_y[m, py, px]
        d2 = dx * dx + dy * dy
        can &= ~both | (d2 <= max_d2)

    # A pixel merges only if all its member tracks can merge.
    pixel_ok = (
        np.bincount(flat[~can], minlength=h * w).reshape(h, w) == 0
    )

    # Merged track per occupied pixel: integer average of exact members.
    occupied = count.sum(axis=0) > 0
    keep = occupied & pixel_ok
    ys, xs = np.nonzero(keep)
    out = TrackStore(n_img)
    if len(ys) == 0:
        return out
    new = np.full((len(ys), n_img, 2), MISSING, np.int32)
    for m in range(n_img):
        cm = count[m, ys, xs]
        has = cm > 0
        new[has, m, 0] = np.floor(sum_x[m, ys, xs][has] / cm[has]).astype(np.int32)
        new[has, m, 1] = np.floor(sum_y[m, ys, xs][has] / cm[has]).astype(np.int32)
    out.append(new)
    return out


# ---------------------------------------------------------------------------
# Outlier filtering (triangulation.rs:1559-1592)


def filter_outliers(store: TrackStore, cameras: list[Camera], cfg) -> None:
    t = len(store)
    if t == 0:
        return
    keep = store.has_point3d.copy()
    pts3 = store.points3d
    angle_cos_threshold = np.cos(cfg.min_angle_between_rays)

    min_cos = np.full(t, np.inf)
    pair_seen = np.zeros(t, bool)
    rays = []
    vis = []
    for i, cam in enumerate(cameras):
        v = store.visible(i)
        ray = pts3 - cam.center[None, :]
        norm = np.linalg.norm(ray, axis=1)
        ok = v & (norm > np.finfo(np.float64).eps)
        rays.append(np.where(ok[:, None], ray / np.maximum(norm, 1e-300)[:, None], 0.0))
        vis.append(ok)
        # Behind-camera rejection.
        keep &= ~v | cam.point_in_front(pts3)

    for i in range(len(cameras)):
        for j in range(i + 1, len(cameras)):
            both = vis[i] & vis[j]
            cosang = np.abs(np.einsum("ti,ti->t", rays[i], rays[j]))
            min_cos = np.where(both, np.minimum(min_cos, cosang), min_cos)
            pair_seen |= both

    keep &= pair_seen & (min_cos <= angle_cos_threshold)
    store.has_point3d = keep


# ---------------------------------------------------------------------------
# Pipeline facade


class SfmPipeline:
    """Incremental SFM pipeline used by reconstruction._run_perspective."""

    def __init__(
        self, images, cfg: ReconstructionConfig, quiet=False, device="cuda",
        phases: dict[str, float] | None = None, mesh=None,
    ):
        self.cfg = cfg
        self.device = device
        # A parallel.Mesh the P3P candidates are scored over (None: on
        # `device`).
        self.mesh = mesh
        # Phase phrase -> seconds (complete()'s finalize split).
        self.phases = phases
        self.tcfg = cfg.triangulation
        self.quiet = quiet
        self.n = len(images)
        self.filenames = [getattr(img, "filename", str(i))
                          for i, img in enumerate(images)]
        self.k = [img.calibration_matrix(cfg.focal_length) for img in images]
        self.shapes = [img.dimensions for img in images]  # (w, h)
        self.store = TrackStore(self.n)
        self.projections: list[np.ndarray | None] = [None] * self.n
        self.cameras: list[Camera | None] = [None] * self.n
        self.remaining = list(range(self.n))
        self.best_initial = None  # (score, (i, j), p2)
        self._pair_f: dict[tuple[int, int], np.ndarray] = {}
        self.rng = np.random.RandomState(self.tcfg.seed)

    # -- sparse phase --------------------------------------------------
    def add_sparse_pair(self, i, j, f, inliers) -> None:
        """triangulation.rs:620-688: extend tracks with the sparse inliers
        and score the pair's essential-matrix decomposition."""
        self._pair_f[(i, j)] = np.asarray(f)
        w, h = self.shapes[i]
        grid = np.zeros((h, w, 3), np.int64)
        xs = np.clip(inliers[:, 0], 0, w - 1)
        ys = np.clip(inliers[:, 1], 0, h - 1)
        grid[ys, xs, 0] = inliers[:, 2]
        grid[ys, xs, 1] = inliers[:, 3]
        grid[ys, xs, 2] = 1
        extend_tracks(self.store, i, j, grid, self._search_radius(j))

        both = self.store.visible(i) & self.store.visible(j)
        pts_pair = np.stack(
            [self.store.pts[both, i], self.store.pts[both, j]], axis=1
        )
        res = find_projection_matrix(f, self.k[i], self.k[j], pts_pair, self.device)
        if res is None:
            return
        p2, score = res
        if self.best_initial is None or score > self.best_initial[0]:
            self.best_initial = (score, (i, j), p2)

    def pair_f(self, i, j):
        return self._pair_f.get((i, j))

    def _search_radius(self, image_i):
        w, h = self.shapes[image_i]
        max_dim = max(w, h)
        denom = self.tcfg.tracks_radius_denominator
        if max_dim > denom:
            return self.tcfg.extend_tracks_search_radius * max_dim // denom
        return self.tcfg.extend_tracks_search_radius

    def _triangulate_all_tracks(self):
        pts3, ok = triangulate_tracks_np(
            self.store.pts, self.projections,
            self.tcfg.perspective_scale_threshold, self.device,
        )
        self.store.points3d = pts3
        self.store.has_point3d = ok

    def recover_camera_poses(self) -> list[int]:
        """triangulation.rs:710-811 driven to exhaustion
        (reconstruction.rs:627-666), with the reference's per-recovery
        'Recovered pose for images X in N seconds' prints
        (reconstruction.rs:646-657)."""
        import time as _time

        def _recovered(images: list[int], t0: float) -> None:
            if not self.quiet:
                names = ", ".join(self.filenames[i] for i in images)
                print(
                    f"Recovered pose for images {names}"
                    f" in {_time.monotonic() - t0:.3f} seconds"
                )

        order: list[int] = []
        if self.best_initial is None:
            return order
        t0 = _time.monotonic()
        score, (i0, j0), p2 = self.best_initial
        k1, k2 = self.k[i0], self.k[j0]
        self.projections[i0] = k1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
        self.cameras[i0] = Camera.from_matrix(k1, np.eye(3), np.zeros(3))
        self.cameras[j0] = Camera.from_matrix(k2, p2[:, :3], p2[:, 3])
        self.projections[j0] = k2 @ p2
        self._triangulate_all_tracks()
        self.remaining = [r for r in self.remaining if r not in (i0, j0)]
        order += [i0, j0]
        _recovered(order, t0)

        while self.remaining:
            t0 = _time.monotonic()
            # Most 3D-point overlaps (triangulation.rs:752-790).
            counts = {
                r: int(
                    (self.store.visible(r) & self.store.has_point3d).sum()
                )
                for r in self.remaining
            }
            best_r = max(self.remaining, key=lambda r: counts[r])
            self.remaining.remove(best_r)

            linked = self.store.visible(best_r) & self.store.has_point3d
            if linked.sum() < self.tcfg.ransac_n:
                continue
            pts2d = self.store.pts[linked, best_r].astype(np.float64)
            pts3d = self.store.points3d[linked]
            const_err = self._existing_reproj_error(linked)
            cam = recover_pose_ransac(
                pts2d,
                pts3d,
                const_err,
                self.k[best_r],
                max(self.shapes[best_r]),
                self.tcfg,
                self.rng,
                self.device,
                self.mesh,
            )
            if cam is None:
                continue
            self.cameras[best_r] = cam
            self.projections[best_r] = cam.projection()
            self._triangulate_all_tracks()
            order.append(best_r)
            _recovered([best_r], t0)

        # Sparse bootstrap tracks are discarded before the dense phase
        # (triangulation.rs:813-815).
        self.store = TrackStore(self.n)
        return order

    def _existing_reproj_error(self, linked) -> np.ndarray:
        """Max reprojection error of the linked tracks over the cameras
        recovered so far (the hypothesis-independent part of the RANSAC
        score under fixed 3D points)."""
        idx = np.nonzero(linked)[0]
        err = np.zeros(len(idx))
        pts3 = self.store.points3d[idx]
        h3 = np.concatenate([pts3, np.ones((len(idx), 1))], axis=1)
        for i, p in enumerate(self.projections):
            if p is None:
                continue
            vis = self.store.pts[idx, i, 0] != MISSING
            pp = h3 @ p.T
            with np.errstate(all="ignore"):
                pp2 = pp[:, :2] / pp[:, 2:3]
            e = np.linalg.norm(pp2 - self.store.pts[idx, i], axis=1)
            err = np.where(vis & np.isfinite(e), np.maximum(err, e), err)
        return err

    # -- dense phase ----------------------------------------------------
    def add_dense_pair(self, i, j, correlated) -> None:
        grid = correlated.astype(np.int64)
        extend_tracks(self.store, i, j, grid, self._search_radius(j))

    def merge_tracks(self, image_i) -> None:
        """Per-image merge (reconstruction.rs:726 -> triangulation.rs:
        1421-1539). DEVIATION: the reference retriangulates every track
        after each merge (triangulation.rs:1538), but between dense-
        phase merges nothing reads points3d — pose recovery is already
        complete, extend/merge use 2D tracks only, and complete()
        begins with its own full retriangulation. Deferring it changes
        no output and removes an all-tracks device DLT per image
        (~0.25 s each at the 5-view bench scale)."""
        self.store = merge_tracks(
            self.store, image_i, self.shapes[image_i], self.tcfg
        )

    # -- finalize ---------------------------------------------------------
    def complete(self, max_points=None, bundle_adjustment=True) -> Surface:
        """triangulation.rs:817-864.

        The reference times this finalization as its own printed phase
        (reconstruction.rs:754-790); the quiet PhaseTimers here add the
        DLT / outlier-filter / BA split to `phases` (the DetailTimer
        prints stay opt-in via CVTPU_PHASE_DETAIL).
        """
        with PhaseTimer("Finalize DLT", True, self.phases), DetailTimer(
            "final DLT triangulation"
        ):
            self._triangulate_all_tracks()
        live = [i for i, p in enumerate(self.projections) if p is not None]
        cameras = [self.cameras[i] for i in live]
        # Remap tracks onto the surviving cameras (prune_projections,
        # triangulation.rs:913-938).
        self.store.pts = self.store.pts[:, live]
        self.store.n_images = len(live)
        self.projections = [self.projections[i] for i in live]
        self.cameras = cameras

        with PhaseTimer("Finalize outlier filter", True, self.phases), DetailTimer(
            "outlier filter"
        ):
            filter_outliers(self.store, cameras, self.tcfg)
            self._compact()

        if bundle_adjustment and len(self.store):
            with PhaseTimer("Finalize bundle adjustment", True, self.phases), DetailTimer(
                "bundle adjustment"
            ):
                new_cams = ba.bundle_adjust(
                    self.store, cameras, self.tcfg, quiet=self.quiet, device=self.device
                )
            if new_cams is not None:
                self.cameras = cameras = new_cams
                self.projections = [c.projection() for c in cameras]

        if max_points is not None and len(self.store) > max_points:
            keep = self.rng.choice(len(self.store), max_points, replace=False)
            self.store.pts = self.store.pts[keep]
            self.store.points3d = self.store.points3d[keep]
            self.store.has_point3d = self.store.has_point3d[keep]

        return Surface(
            points3d=self.store.points3d,
            tracks=self.store.pts,
            cameras=list(cameras),
        )

    def _compact(self):
        keep = self.store.has_point3d
        self.store.pts = self.store.pts[keep]
        self.store.points3d = self.store.points3d[keep]
        self.store.has_point3d = self.store.has_point3d[keep]
