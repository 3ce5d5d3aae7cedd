"""Device-batched SFM primitives: P3P candidate scoring + DLT nullspaces
(counterpart of cybervision_tpu/ops/sfm_device.py).

  * P3P solving stays a vectorised host float64 closed form
    (ops.sfm.solve_p3p); candidate SCORING — the O(candidates x tracks)
    reprojection sweep — runs on the run's device in float32, chunked
    over the hypothesis axis so only a (chunk, T) error tile is live.
  * The DLT normal matrices (built on the host in float64) solve as one
    batched float32 eigh on the device, then one float64
    inverse-iteration polish on the host restores reference-grade
    precision (the smallest eigenvalue is ~0 by construction, so one
    solve against ata + eps*I amplifies the nullspace component to
    machine accuracy).

The JAX package pads the track and hypothesis axes to power-of-two
buckets to reuse compiled programs; torch has no compile step, so the
port runs the real lengths (padding never counts in either).

Under a parallel.Mesh the candidate axis of P3P scoring is cut into
mesh.size contiguous blocks, block i scored on mesh.devices[i] (the JAX
package's _p3p_score_sharded, cybervision_tpu/ops/sfm_device.py:
118-170).
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

# p3p_score's scored blocks since the counter was last set to 0: one per
# call without a mesh, one per shard that scored candidates under one.
# sharded_launches counts the calls under a mesh.
launches = 0
sharded_launches = 0

# cuSOLVER's batched eigh (cusolverDnXsyevBatched under torch 2.11 and
# CUDA 12.8 on the H100) refuses 32,767 matrices and more with
# CUSOLVER_STATUS_INVALID_VALUE; 16,384 pass. dlt_nullspaces calls it in
# batches of this size.
DLT_EIGH_BATCH = 16_384


def _p3p_score_chunk(proj_c, s2d_c, s3d_c, h3, pts2d, const_err, inlier_t, points_t):
    """One hypothesis chunk of _p3p_score (the JAX package's
    _p3p_score_jit body): (count, err_max, sample_ok)."""
    sh = torch.cat([s3d_c, torch.ones(s3d_c.shape[:2] + (1,), dtype=F32, device=s3d_c.device)], dim=2)
    sp = torch.einsum("bik,bnk->bni", proj_c, sh)
    sp2 = sp[..., :2] / sp[..., 2:3]
    serr = torch.linalg.vector_norm(sp2 - s2d_c, dim=2)
    sample_ok = torch.all(torch.isfinite(serr) & (serr < inlier_t), dim=1)
    pp = torch.einsum("bik,tk->bti", proj_c, h3)
    pp2 = pp[..., :2] / pp[..., 2:3]
    err = torch.linalg.vector_norm(pp2 - pts2d[None], dim=2)
    err = torch.maximum(err, const_err[None])
    good = torch.isfinite(err) & (err < points_t)
    count = torch.sum(good, dim=1)
    err_max = torch.amax(torch.where(good, err, 0.0), dim=1)
    return count, err_max, sample_ok


def p3p_score(
    proj: np.ndarray,
    s2d: np.ndarray,
    s3d: np.ndarray,
    pts3d: np.ndarray,
    pts2d: np.ndarray,
    const_err: np.ndarray,
    inlier_t: float,
    points_t: float,
    chunk: int = 256,
    device="cuda",
    mesh=None,
):
    """Scores P3P candidates on `device` (sfm_device.p3p_score of the JAX
    package), or over the shards of `mesh`. proj (B, 3, 4) candidate
    K[R|t] (NaN where invalid);
    s2d/s3d (B, 3, 2|3) each candidate's sampled observations/points;
    pts3d (T, 3), pts2d (T, 2), const_err (T,) the linked tracks.

    Per candidate: the sample-consistency gate (every sampled point
    reprojects within inlier_t, triangulation.rs:1110-1117), the count
    of tracks whose error max(reprojection, const_err) is under points_t,
    and the largest such error (triangulation.rs:1119-1135). float32 on
    the device, `chunk` candidates at a time. Returns numpy
    (count (B,), err_max (B,), sample_ok (B,)).

    Under a mesh block i holds candidates [i * per, (i + 1) * per), per a
    multiple of chunk (and of 128, so that every chunk's operands sit at
    the unsharded run's alignment), scored on mesh.devices[i]; the
    results concatenate in block order. Each candidate's chunk is the
    unsharded run's, and its count, error and gate come from its own
    row, so the result equals the unsharded one exactly. A block that
    starts past B is empty and its shard scores nothing: `launches`
    counts the blocks scored, so a caller sees a call that did not
    reach every shard."""
    global launches, sharded_launches
    b = len(proj)
    if mesh is None:
        blocks = [(torch.device(device), 0, b)]
    else:
        step = math.lcm(chunk, 128)
        per = -(-b // (step * mesh.size)) * step
        blocks = [(d, i * per, min((i + 1) * per, b)) for i, d in enumerate(mesh.devices)]
        sharded_launches += 1
    t = len(pts3d)
    tracks = {}
    for dev in dict.fromkeys(d for d, _, _ in blocks):
        p3 = torch.as_tensor(np.asarray(pts3d, np.float32), device=dev)
        tracks[dev] = (
            torch.cat([p3, torch.ones((t, 1), dtype=F32, device=dev)], dim=1),
            torch.as_tensor(np.asarray(pts2d, np.float32), device=dev),
            torch.as_tensor(np.asarray(const_err, np.float32), device=dev),
            torch.tensor(inlier_t, dtype=F32, device=dev),
            torch.tensor(points_t, dtype=F32, device=dev),
        )
    outs = []
    for dev, lo, hi in blocks:
        if lo >= hi:
            continue
        proj_t, s2d_t, s3d_t = (
            torch.as_tensor(np.asarray(a[lo:hi], np.float32), device=dev)
            for a in (proj, s2d, s3d)
        )
        chunks = [
            _p3p_score_chunk(
                proj_t[c0 : c0 + chunk], s2d_t[c0 : c0 + chunk],
                s3d_t[c0 : c0 + chunk], *tracks[dev],
            )
            for c0 in range(0, hi - lo, chunk)
        ]
        outs.append([torch.cat(parts) for parts in zip(*chunks)])
        launches += 1
    if not outs:
        return np.zeros(0, np.int64), np.zeros(0, np.float32), np.zeros(0, bool)
    count, err_max, ok = (
        np.concatenate([p.cpu().numpy() for p in parts]) for parts in zip(*outs)
    )
    return count, err_max, ok


def dlt_nullspaces(ata: np.ndarray, device="cuda") -> np.ndarray:
    """Batched smallest-eigenvector solve for DLT normal matrices.

    ata: (T, 4, 4) float64 PSD (rows normalised, eigenvalues in
    [0, O(1)]). A float32 eigh on `device`, then one host float64
    inverse-iteration step: solving (ata + eps I) h = h32 amplifies the
    near-null component by ~1/(lambda_min + eps), so the polished vector
    is accurate to float64 machine precision wherever the two smallest
    eigenvalues separate. The eigenvector's sign is free. The eigh runs
    in batches of DLT_EIGH_BATCH matrices."""
    a32 = torch.as_tensor(ata, dtype=F32, device=torch.device(device))
    h32 = torch.cat([
        torch.linalg.eigh(a32[i : i + DLT_EIGH_BATCH])[1][:, :, 0]
        for i in range(0, len(a32), DLT_EIGH_BATCH)
    ]).cpu().numpy().astype(np.float64)
    reg = ata + 1e-9 * np.eye(4)[None]
    try:
        h = np.linalg.solve(reg, h32[:, :, None])[:, :, 0]
    except np.linalg.LinAlgError:
        return h32
    norm = np.linalg.norm(h, axis=1, keepdims=True)
    good = np.isfinite(h).all(axis=1, keepdims=True) & (norm > 0)
    return np.where(good, h / np.maximum(norm, 1e-300), h32)
