"""K2: batched RANSAC hypothesis scoring (counterpart of ops/pallas_score.py).

`score_candidates` launches csrc/score_candidates.cu on CUDA tensors and
runs `score_candidates_plain` — the chunked form of
cybervision_tpu/ops/pallas_score.py:score_candidates_xla — on CPU
tensors. Both evaluate ops.epipolar.sampson_error's operation order
without FMA contraction, so per-element errors and the counts agree bit
for bit; the error sums differ only by summation order.
"""

from __future__ import annotations

import torch

from cybervision_tpu_torch import kernels

# Kernel launches since the counter was last set to 0.
launches = 0

# csrc/score_candidates.cu's launch constants: threads per block,
# candidates per thread, and the match rows of a split, one shared-memory
# slab: small, so that the padding rows of the main path's bucketed table
# (60 % of it at 1024^2) leave whole blocks idle and the valid rows still
# spread over several waves of blocks.
THREADS = 128
CANDS_PER_THREAD = 2
SLAB = 256


def score_plan(c: int, m: int) -> dict:
    """The kernel's grid for C candidates against M matches: candidate
    tiles of THREADS * CANDS_PER_THREAD, and the match rows in splits of
    SLAB rows (the last one short, none empty)."""
    per_block = THREADS * CANDS_PER_THREAD
    n_splits = -(-m // SLAB)
    if n_splits > 65535:
        raise ValueError(f"score_candidates: {m} matches need {n_splits} splits, over 65535")
    return {
        "threads": THREADS,
        "cands_per_block": per_block,
        "cand_tiles": -(-c // per_block),
        "split": SLAB,
        "n_splits": n_splits,
    }


def sampson_error(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """First-order epipolar residual (fundamentalmatrix.rs:461-471):
    (p2' F p1)^2 / (|F p1|_xy^2 + |F' p2|_xy^2). f: (..., 3, 3); p1, p2:
    (..., M, 2) broadcasting against f's batch. Returns (..., M)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    fe = f.reshape(f.shape[:-2] + (9,))

    def c(i):
        return fe[..., i, None]

    l_a = c(0) * x1 + c(1) * y1 + c(2)
    l_b = c(3) * x1 + c(4) * y1 + c(5)
    l_w = c(6) * x1 + c(7) * y1 + c(8)
    r_a = c(0) * x2 + c(3) * y2 + c(6)
    r_b = c(1) * x2 + c(4) * y2 + c(7)
    bil = x2 * l_a + y2 * l_b + l_w
    num = bil * bil
    den = l_a * l_a + l_b * l_b + r_a * r_a + r_b * r_b
    return num / den


def score_candidates_plain(ff, p1, p2, m_valid, threshold: float):
    """(count (C,) int32, err_sum (C,) f32): per candidate, the valid
    matches with finite err <= threshold and the sum of their errors.
    Candidates go in chunks so one (chunk, M) error tile is live."""
    total = ff.shape[0]
    m = p1.shape[0]
    chunk = max(1, (1 << 25) // max(m, 1))
    counts, sums = [], []
    for c0 in range(0, total, chunk):
        err = sampson_error(ff[c0 : c0 + chunk], p1, p2)
        fits = torch.isfinite(err) & (err <= threshold) & m_valid[None, :]
        counts.append(fits.sum(dim=1).to(torch.int32))
        sums.append(torch.where(fits, err, 0.0).sum(dim=1))
    if not counts:
        return (
            torch.zeros(0, dtype=torch.int32, device=ff.device),
            torch.zeros(0, dtype=torch.float32, device=ff.device),
        )
    return torch.cat(counts), torch.cat(sums)


def score_candidates(ff, p1, p2, m_valid, threshold: float):
    """Scores candidates ff (C, 3, 3) float32 against matches p1, p2 (M, 2)
    float32 with validity m_valid (M,) bool. CUDA tensors launch the
    kernel on their own device; CPU tensors run score_candidates_plain."""
    global launches
    c = ff.shape[0]
    m = p1.shape[0]
    dev = ff.device
    if ff.dtype != torch.float32 or p1.dtype != torch.float32 or p2.dtype != torch.float32:
        raise TypeError("score_candidates: ff, p1 and p2 must be float32")
    if tuple(ff.shape[1:]) != (3, 3) or p1.shape != (m, 2) or p2.shape != (m, 2):
        raise ValueError(
            f"score_candidates: shapes ff {tuple(ff.shape)}, p1 {tuple(p1.shape)},"
            f" p2 {tuple(p2.shape)}"
        )
    if m_valid.dtype != torch.bool or m_valid.shape != (m,):
        raise ValueError("score_candidates: m_valid must be a (M,) bool tensor")
    if any(t.device != dev for t in (p1, p2, m_valid)):
        raise ValueError("score_candidates: all inputs must share one device")
    if dev.type == "cpu":
        return score_candidates_plain(ff, p1, p2, m_valid, threshold)
    if dev.type != "cuda":
        raise ValueError(f"score_candidates: unsupported device {dev}")
    plan = score_plan(c, m)
    ffl = ff.reshape(c, 9).contiguous()
    # (M, 4) rows (x1, y1, x2, y2), read as float4; the mask as bytes.
    pts = torch.cat([p1, p2], dim=1).contiguous()
    mask = m_valid.contiguous()
    part_count = torch.empty((plan["n_splits"], c), dtype=torch.int32, device=dev)
    part_sum = torch.empty((plan["n_splits"], c), dtype=torch.float32, device=dev)
    count = torch.empty(c, dtype=torch.int32, device=dev)
    esum = torch.empty(c, dtype=torch.float32, device=dev)
    # The C entry point launches on the host thread's current device.
    with kernels.on_device(dev):
        err = kernels.library().cv_score_candidates(
            ffl.data_ptr(), pts.data_ptr(), mask.data_ptr(), c, m,
            float(threshold), plan["cand_tiles"], plan["n_splits"],
            part_count.data_ptr(), part_sum.data_ptr(),
            count.data_ptr(), esum.data_ptr(), kernels.stream_of(dev),
        )
    kernels.check(err, "cv_score_candidates")
    launches += 1
    return count, esum
