"""Fundamental-matrix estimation by batched RANSAC, affine subset
(counterpart of cybervision_tpu/ops/epipolar.py).

Reference (fundamentalmatrix.rs): up to 1M RANSAC iterations in 50k
batches with early exit; the affine model from 4 mean-centred
correspondences (fundamentalmatrix.rs:260-286); Sampson scoring over all
matches (fundamentalmatrix.rs:452-471). Hypotheses are a leading tensor
batch axis: one batch draws its sample indices, gathers their packed
coordinates (kernel K3), redraws conflicting slots, solves every sample
in closed form, scores every candidate against every match (kernel K2)
and keeps the lexicographic (count desc, mean error asc) best.

RNG: JAX's threefry stream (utils.prng) under the JAX package's key
schedule, so the port draws the same samples and picks the same winner:
key = PRNGKey(RansacConfig.seed), one `key, sub = split(key)` per round
(epipolar.py:1437, 1467, 1494), and one randint(sub, (13, n, B), 0,
top_limit) of int32 draws per batch (epipolar.py:666).

Under a parallel.Mesh each round's batch splits over the devices
(ransac_batch_sharded, epipolar.py:969-1035): shard i draws and scores
batch/n hypotheses from keys[i] of split(sub, n), K3 and K2 launching on
its device, and the per-device winners merge on the lead device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
from cybervision_tpu_torch.errors import RansacError
from cybervision_tpu_torch.ops.gather import gather_packed
from cybervision_tpu_torch.ops.score import sampson_error, score_candidates
from cybervision_tpu_torch.parallel import AUTO, replicate, resolve_mesh
from cybervision_tpu_torch.utils import prng
from cybervision_tpu_torch.utils.buckets import pow2_bucket

F32 = torch.float32
I32 = torch.int32

def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots(c3, c2, c1, c0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0, batched: (roots (..., 3),
    valid (..., 3)), with quadratic/linear fallbacks when leading
    coefficients vanish."""
    tiny = 1e-20
    k3 = torch.arange(3, dtype=c3.dtype, device=c3.device)
    a = torch.where(torch.abs(c3) > tiny, c3, torch.ones_like(c3))
    b, c, d = c2 / a, c1 / a, c0 / a
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    shift = -b / 3.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_single = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq) + shift
    pm = torch.clamp(p, max=-tiny)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    root_triple = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k3 / 3.0) + shift[..., None]
    three = disc <= 0
    cubic_r = torch.where(three[..., None], root_triple, root_single[..., None].expand(root_triple.shape))
    cubic_ok = torch.stack([torch.ones_like(three), three, three], dim=-1)

    qa = torch.where(torch.abs(c2) > tiny, c2, torch.ones_like(c2))
    qd = c1 * c1 - 4.0 * c2 * c0
    qs = torch.sqrt(torch.clamp(qd, min=0.0))
    quad_r = torch.stack([(-c1 + qs) / (2.0 * qa), (-c1 - qs) / (2.0 * qa), torch.zeros_like(qa)], dim=-1)
    quad_ok = torch.stack([qd >= 0, qd >= 0, torch.zeros_like(qd, dtype=torch.bool)], dim=-1)
    lin = -c0 / torch.where(torch.abs(c1) > tiny, c1, torch.ones_like(c1))
    lin_r = torch.stack([lin, lin, lin], dim=-1)
    lin_ok = torch.stack(
        [torch.abs(c1) > tiny, torch.zeros_like(c1, dtype=torch.bool),
         torch.zeros_like(c1, dtype=torch.bool)], dim=-1,
    )
    is_cubic = (torch.abs(c3) > tiny)[..., None]
    is_quad = ~is_cubic & (torch.abs(c2) > tiny)[..., None]
    roots = torch.where(is_cubic, cubic_r, torch.where(is_quad, quad_r, lin_r))
    ok = torch.where(is_cubic, cubic_ok, torch.where(is_quad, quad_ok, lin_ok))
    return roots, ok


def solve_affine_batch(s1: torch.Tensor, s2: torch.Tensor, rank_eps: float):
    """Affine fundamental matrices from 4-point samples s1, s2 (B, 4, 2):
    returns (f (B, 3, 3), valid (B,)). The nullvector of the mean-centred
    (B, 4, 4) system [x2 y2 x1 y1] is the 4D cross product of three rows;
    the degeneracy test is the second-largest singular value >= eps
    (fundamentalmatrix.rs:273) from A^T A's characteristic cubic;
    F = [[0,0,v0],[0,0,v1],[v2,v3,-v.mean]] (fundamentalmatrix.rs:260-286),
    not normalised by F[2,2] (Sampson scoring is scale-invariant)."""
    a = torch.cat([s2, s1], dim=2)
    mean = torch.mean(a, dim=1, keepdim=True)
    a = a - mean
    norm = torch.clamp(torch.amax(torch.abs(a), dim=(1, 2), keepdim=True), min=1e-12)
    an = a / norm
    r = an[:, :3, :]

    def det3(j, k, l):
        c0, c1, c2 = r[:, :, j], r[:, :, k], r[:, :, l]
        return (
            c0[:, 0] * (c1[:, 1] * c2[:, 2] - c1[:, 2] * c2[:, 1])
            - c1[:, 0] * (c0[:, 1] * c2[:, 2] - c0[:, 2] * c2[:, 1])
            + c2[:, 0] * (c0[:, 1] * c1[:, 2] - c0[:, 2] * c1[:, 1])
        )

    v = torch.stack(
        [det3(1, 2, 3), -det3(0, 2, 3), det3(0, 1, 3), -det3(0, 1, 2)], dim=1
    )
    vn = torch.sqrt(torch.sum(v * v, dim=1))
    v = v / torch.clamp(vn, min=1e-30)[:, None]

    m = torch.einsum("bij,bik->bjk", an, an)
    t1 = torch.einsum("bii->b", m)
    t2 = torch.sum(m * m, dim=(1, 2))
    t3 = torch.einsum("bij,bjk,bki->b", m, m, m)
    c2 = 0.5 * (t1 * t1 - t2)
    c1 = (t1**3 - 3.0 * t1 * t2 + 2.0 * t3) / 6.0
    roots, roots_ok = cubic_roots(torch.ones_like(t1), -t1, c2, -c1)
    roots = torch.where(roots_ok, torch.clamp(roots, min=0.0), 0.0)
    med = torch.sum(roots, dim=1) - torch.amax(roots, dim=1) - torch.amin(roots, dim=1)
    s1_sv = torch.sqrt(torch.clamp(med, min=0.0)) * norm[:, 0, 0]
    valid = (s1_sv >= rank_eps) & (vn > 1e-12) & torch.all(torch.isfinite(v), dim=1)
    e = torch.sum(v * mean[:, 0, :], dim=1)
    zeros = torch.zeros_like(e)
    f = torch.stack(
        [
            torch.stack([zeros, zeros, v[:, 0]], dim=1),
            torch.stack([zeros, zeros, v[:, 1]], dim=1),
            torch.stack([v[:, 2], v[:, 3], -e], dim=1),
        ],
        dim=1,
    )
    return f, valid


def pack_coord_table(table: np.ndarray) -> np.ndarray | None:
    """(M, 4) match table -> (2, M) int32 with (x, y) packed 16/16 per
    image, or None when the coordinates are not exactly representable
    (non-integral or >= 2^15)."""
    if table.size == 0:
        return None
    if not np.all((table >= 0) & (table < 32768)):
        return None
    if not np.all(table == np.floor(table)):
        return None
    xi = table.astype(np.int64)
    packed = np.stack([xi[:, 0] * 65536 + xi[:, 1], xi[:, 2] * 65536 + xi[:, 3]])
    return packed.astype(np.int32)


def _lex_topk_iter(count: torch.Tensor, err: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices by (count desc, err asc, index asc) via k argmax
    passes; non-finite errors rank last within their count class."""
    c = count.to(I32).clone()
    picks = []
    for _ in range(k):
        cmax = torch.max(c)
        em = torch.where((c == cmax) & torch.isfinite(err), err, torch.inf)
        emin = torch.min(em)
        hit = (c == cmax) & ((em == emin) | (emin == torch.inf))
        i = torch.argmax(hit.to(torch.uint8))
        picks.append(i)
        c[i] = -1
    return torch.stack(picks)


def _ransac_batch_core(
    key: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    m_valid: torch.Tensor,
    top_limit: int,
    threshold: float,
    min_inlier_distance: float,
    min_count: int,
    n_samples: int,
    batch: int,
    rank_eps: float,
    packed_t: torch.Tensor | None = None,
    top_k: int = 1,
):
    """One batch of affine RANSAC hypotheses (the affine branch of
    cybervision_tpu epipolar._ransac_batch_core).

    key: a utils.prng key. p1, p2: (M, 2) f32 matches, m_valid: (M,)
    mask; samples are drawn from [0, top_limit) — the best-distance
    prefix (fundamentalmatrix.rs:159-162) — as JAX's one randint(key,
    (13, n_samples, batch)) for the 13 redraw rounds. Conflicting slots
    closer than min_inlier_distance on any axis are redrawn against
    earlier slots (fundamentalmatrix.rs:155-175).

    Returns the top_k hypotheses: (f (K, 3, 3), count (K,), mean_err (K,))."""
    dev = p1.device
    all_idx = prng.randint(key, (13, n_samples, batch), 0, top_limit, device=dev)
    tril = torch.tril(torch.ones((n_samples, n_samples), dtype=torch.bool, device=dev), -1)

    if packed_t is None:
        p_all_t = torch.cat([p1, p2], dim=1).T.contiguous()  # (4, M)
        all_coords = p_all_t[:, all_idx.long()]  # (4, 13, n, B)

        def round_coords(i):
            return all_coords[:, i]

    else:
        all_packed = gather_packed(packed_t, all_idx)  # (2, 13, n, B)

        def round_coords(i):
            pk = all_packed[:, i]
            hi = torch.bitwise_right_shift(pk, 16).to(F32)
            lo = torch.bitwise_and(pk, 0xFFFF).to(F32)
            return torch.stack([hi[0], lo[0], hi[1], lo[1]])

    def close_pairs(coords):
        diff = torch.abs(coords[:, :, None, :] - coords[:, None, :, :])
        return torch.any(diff < min_inlier_distance, dim=0)  # (n, n, B)

    coords = round_coords(0)
    for i in range(12):
        conflict = torch.any(close_pairs(coords) & tril[:, :, None], dim=1)
        coords = torch.where(conflict[None], round_coords(i + 1), coords)
    close = close_pairs(coords)
    iu = torch.triu_indices(n_samples, n_samples, 1, device=dev)
    sample_ok = ~torch.any(close[iu[0], iu[1]], dim=0)  # (B,)
    s1 = coords[0:2].permute(2, 1, 0)  # (B, n, 2)
    s2 = coords[2:4].permute(2, 1, 0)

    f, valid = solve_affine_batch(s1, s2, rank_eps)
    valid = valid & sample_ok
    # The sampled points themselves must fit (fundamentalmatrix.rs:206-209).
    own = sampson_error(f, s1, s2)  # (B, n)
    own_ok = torch.all(torch.isfinite(own) & (own <= threshold), dim=1)

    count, err_sum = score_candidates(f.contiguous(), p1, p2, m_valid, threshold)
    good = valid & own_ok & (count >= min_count)
    count = torch.where(good, count, 0)
    mean_err = err_sum / torch.clamp(count, min=1)
    top_i = _lex_topk_iter(count, mean_err, min(top_k, f.shape[0]))
    return f[top_i], count[top_i], mean_err[top_i]


def ransac_batch_sharded(
    mesh,
    key,
    p1,
    p2,
    m_valid,
    top_limit: int,
    threshold: float,
    min_inlier_distance: float,
    min_count: int,
    *,
    n_samples: int,
    batch: int,
    rank_eps: float,
    packed_t=None,
    top_k: int = 1,
):
    """_ransac_batch_core with the hypothesis batch split over a
    parallel.Mesh: shard i runs batch // n hypotheses on mesh.devices[i]
    drawn from keys[i] of split(key, n), as each JAX device draws from
    its split of the round key (epipolar.py:1003); the per-device top-K
    merge on the lead device by (count desc, error asc, index asc), the
    batch's own rule.

    The match table (p1, p2, m_valid, packed_t) is copied once to each
    distinct device. Returns (f (K, 3, 3), count (K,), mean_err (K,)) on
    the lead device."""
    n = mesh.size
    per = max(1, batch // n)
    tables = [
        None if t is None else replicate(mesh, t)
        for t in (p1, p2, m_valid, packed_t)
    ]
    keys = prng.split(key, n)
    fs, cs, es = [], [], []
    for i in range(n):
        p1_i, p2_i, mv_i, pk_i = (None if t is None else t[i] for t in tables)
        f_i, c_i, e_i = _ransac_batch_core(
            keys[i], p1_i, p2_i, mv_i, top_limit, threshold,
            min_inlier_distance, min_count, n_samples, per, rank_eps,
            packed_t=pk_i, top_k=top_k,
        )
        fs.append(f_i.to(mesh.lead))
        cs.append(c_i.to(mesh.lead))
        es.append(e_i.to(mesh.lead))
    f, c, e = torch.cat(fs), torch.cat(cs), torch.cat(es)
    top = _lex_topk_iter(c, e, min(top_k, c.shape[0]))
    return f[top], c[top], e[top]


@dataclasses.dataclass
class FundamentalMatrixResult:
    f: np.ndarray  # (3, 3) float64
    inliers: np.ndarray  # (K, 4) int64 rows (x1, y1, x2, y2)
    matches_count: int


def _sampson_np(f: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """sampson_error in plain f64 numpy (host rescoring of the winner)."""
    ones = np.ones((p1.shape[0], 1), np.float64)
    h1 = np.concatenate([p1, ones], axis=1)
    h2 = np.concatenate([p2, ones], axis=1)
    f_p1 = h1 @ f.T
    ft_p2 = h2 @ f
    num = np.einsum("mi,mi->m", f_p1, h2) ** 2
    den = f_p1[:, 0] ** 2 + f_p1[:, 1] ** 2 + ft_p2[:, 0] ** 2 + ft_p2[:, 1] ** 2
    return num / den


def _score_inliers(f, p1, p2, threshold):
    err = _sampson_np(np.asarray(f, np.float64), p1, p2)
    return np.isfinite(err) & (err <= threshold)


def _pick_winner(matches, pool, t) -> FundamentalMatrixResult:
    """The pool's (count, -err) winner with its inliers rescored in f64
    against all matches (affine: no LM refinement to weigh in)."""
    pts1 = matches[:, 0:2].astype(np.float64)
    pts2 = matches[:, 2:4].astype(np.float64)
    f = pool[0][0]
    fits = _score_inliers(f, pts1, pts2, t)
    return FundamentalMatrixResult(
        f=f, inliers=matches[fits], matches_count=int(fits.sum())
    )


def find_fundamental_matrix(
    matches: np.ndarray,
    projection: ProjectionMode,
    max_dimension: float,
    cfg: RansacConfig = RansacConfig(),
    progress=None,
    device="cuda",
    mesh=AUTO,
) -> FundamentalMatrixResult:
    """RANSAC round loop (fundamentalmatrix.rs:103-147), affine projection.

    matches: (M, 4) rows (x1, y1, x2, y2) sorted by ascending descriptor
    distance. Batches of cfg.check_interval hypotheses run until the
    budget is spent or the best count exceeds the early-exit count; the
    JAX package's fused all-rounds program is this same loop (its pool
    is identical to absorbing round by round). Under a mesh (AUTO reads
    parallel.pipeline_mesh()) every round runs ransac_batch_sharded.
    Every round draws from the next `sub` of JAX's key chain, so the
    winner is the JAX package's for the same seed."""
    if projection != ProjectionMode.AFFINE:
        raise NotImplementedError(
            "perspective RANSAC is not ported yet (ROADMAP.md Queue 1:"
            " perspective RANSAC)"
        )
    ransac_k, n, t, d, d_early = cfg.params(projection)
    mesh = resolve_mesh(mesh, device)
    if mesh is not None:
        device = mesh.lead
    m = len(matches)
    if m < d + n:
        raise RansacError("Not enough matches")
    mb = pow2_bucket(m, floor=2048, factor=4)
    mpad = np.zeros((mb, 4), matches.dtype)
    mpad[:m] = matches
    p1 = torch.as_tensor(mpad[:, 0:2], dtype=F32, device=device)
    p2 = torch.as_tensor(mpad[:, 2:4], dtype=F32, device=device)
    m_valid = torch.as_tensor(np.arange(mb) < m, device=device)
    top_limit = min(m, cfg.top_inliers)
    packed_np = pack_coord_table(mpad)
    packed = None if packed_np is None else torch.as_tensor(packed_np, device=device)
    args = (top_limit, t, float(cfg.min_inlier_distance), d + n)
    kw = dict(n_samples=n, batch=cfg.check_interval, rank_eps=cfg.rank_epsilon)
    if mesh is None:
        def sweep(sub):
            return _ransac_batch_core(sub, p1, p2, m_valid, *args, packed_t=packed, **kw)
    else:
        def sweep(sub):
            return ransac_batch_sharded(
                mesh, sub, p1, p2, m_valid, *args, packed_t=packed, **kw
            )
    key = prng.prng_key(cfg.seed)
    n_batches = max(1, ransac_k // cfg.check_interval)
    pool: list[tuple[np.ndarray, int, float]] = []
    for i in range(n_batches):
        key, sub = prng.split(key)
        f_b, c_b, e_b = sweep(sub)
        fs = f_b.to(torch.float64).cpu().numpy()
        counts = c_b.cpu().numpy()
        errs = e_b.to(torch.float64).cpu().numpy()
        for j in range(len(counts)):
            if counts[j] > 0:
                pool.append((fs[j], int(counts[j]), float(errs[j])))
        pool.sort(key=lambda e: (-e[1], e[2]))
        del pool[1:]
        best_count = pool[0][1] if pool else 0
        if progress is not None:
            progress.report_status((i + 1) / n_batches)
            if hasattr(progress, "report_matches"):
                progress.report_matches(best_count)
        if best_count > d_early:
            break
    if not pool:
        raise RansacError("No reliable matches found")
    return _pick_winner(matches, pool, t)
