#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cybervision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises on failure:

1. Print the card's name and power limit, build the hand-written
   kernels (cybervision_tpu_torch/csrc/*.cu, nvcc for sm_90a), and print
   each kernel's registers, spills and shared memory (ptxas -v).
2. Hold every kernel against its plain PyTorch version on the card, at
   the shapes the 1024x1024 main path gives it, and time both:
     K1 ncc_sweep  — the refine sweep of the finest level in its "horiz"
                     (main path), "vert" and per-pixel forms; tolerances
                     of tests/test_pallas_ncc.py (under 0.5 % of valid
                     flags differ, corr within 1e-4, over 99.5 % of
                     positions equal); also "horiz" and "vert" at 999x777
                     (no multiple of a tile) and at windows 8 and 128 on
                     a 300x280 plane;
     K2 score      — 50,000 affine candidates against the match table at
                     8192 rows and at the main path's bucket; counts equal,
                     sums within rtol 1e-5; also 50,001 candidates against
                     the bucket with holes in the middle of its mask, and
                     with no row valid;
     K3 gather     — (13, 4, 50,000) draws from the packed table at the
                     same two sizes; exact. torch.index_select is timed
                     beside it as the library yardstick, in turns with
                     the kernel: CUDA events around 200 calls (5 turns,
                     medians), the device time per call from
                     torch.profiler (5 turns of 50 calls in one profile),
                     and the host time per call (perf_counter around
                     1,000 calls with no sync, 5 turns, medians), there
                     also of the same launch through PyTorch's public
                     host API (gather_public_path);
     K1 wide       — both static forms at 1024x1024 and window 192 (two
                     chunks of offsets per stripe), bit-equal to the
                     plain version and timed; the row-halo form at 192
                     over phase 4's mesh, bit-equal to the plain version;
     draws         — the threefry draws of one RANSAC round (utils.prng,
                     (13, 4, 50,000) int32) equal on the card and on the
                     CPU, timed beside torch.randint, the draw they
                     replaced.
3. Run the main path end to end through reconstruction.reconstruct: the
   synthetic 1024x1024 SEM pair, ReconstructionConfig(projection=AFFINE,
   mesh=VERTEX_COLORS), to a PLY in a temporary directory. One warm-up
   run, then three timed runs, each with the kernels' launch counters set
   to 0 just before and read just after. Checks: every kernel launched,
   the PLY holds over 30 % of the pixels as vertices, and its depth tracks
   the planted disparity. Then one more warm run under torch.profiler:
   the card's busy share of the run, the ops by device time, and each
   kernel's device milliseconds in that run. Then RANSAC alone on the
   main path's matches with an early exit no count reaches, so all 20
   rounds run: K2 and K3 launches and device milliseconds per run, and
   its seconds. Phases 1 to 3 run without a mesh: the single-card path.
4. The multi-device path over a mesh: every visible card when there are
   two or more, else four row shards on the one card (the sharded code
   runs for real either way: halo exchange, global row bounds, a launch
   per shard). K1s, ncc_sweep_sharded, at phase 2's 1024x1024 fields in
   its three forms must equal the unsharded K1 exactly and agree with
   its sharded plain version within K1's tolerances; its time includes
   the halo exchange. Then the main path end to end under the mesh (a
   warm-up and three timed runs, phase 3's gates, the launches per run
   checked against the plan: one K1 per shard on each sharded level,
   one K2 and one K3 per shard per RANSAC round), one more run under
   the profiler for K1s's device milliseconds per run, and
   correlate_images under the mesh for the F of an unsharded run, whose delta plane must
   equal the unsharded one.

The last two lines of standard output are one JSON object per kernel
record ({"kernels": [...]}) and the device record ({"ok": true, ...}).
The script exits non-zero, printing neither, when there is no CUDA device
or any phase fails. It imports nothing of JAX and nothing of the JAX
package, and needs no Pillow: images are built in memory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
from scipy import ndimage

SIZE = 1024
BATCH = 50_000  # RansacConfig.check_interval: candidates per RANSAC round
DRAW_ROUNDS = 13  # redraw rounds of _ransac_batch_core's sampling
GATHER_TURNS = 5
GATHER_PROFILED_CALLS = 50  # per turn, in the one profile
GATHER_HOST_CALLS = 1000  # per turn, timed on the host clock
WIDE_WINDOW = 192  # two chunks of offsets per stripe in K1's static forms
# Device kernels of each wrapper, as the profiler names them.
KERNEL_NAMES = {
    "ncc_sweep": ("sweep_tile_kernel", "sweep_pixel_kernel", "box_sums_kernel"),
    "score_candidates": ("score_split_kernel", "score_reduce_kernel"),
    "gather_packed": ("gather_packed_kernel",),
}
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. Bounds are stated against these at 700 W.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# tests/test_pallas_ncc.py:50-60
SWEEP_FLIP_MAX = 0.005
SWEEP_CORR_ATOL = 1e-4
SWEEP_POS_EQ_MIN = 0.995
SCORE_RTOL = 1e-5
# K1's work per evaluated hypothesis in the separable form that the plain
# version and the Pallas kernel use, _box11(img1 * warp): 1 product, 10
# row sums, 10 column sums. The warp's box statistics are counted apart,
# per stripe and pixel: 20 sums of w0, 20 of w0^2 and the square.
SWEEP_OPS_PER_EVAL = 21.0


def synth_sem_pair(h: int, w: int, seed: int = 0):
    """The bench's synthetic SEM pair (a copy of bench.synth_sem_pair) plus
    its planted disparity: img2(x, y) = img1(x + d, y)."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (h, w))
    base = ndimage.gaussian_filter(base, 1.2)
    bumps = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 8.0)
    img1 = base * 0.6 + bumps * 0.4
    img1 = (img1 - img1.min()) / (img1.max() - img1.min()) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disparity = 2.0 + 6.0 * (ys / h) ** 2 + 3.0 * np.sin(xs / w * 3.0)
    img2 = ndimage.map_coordinates(
        img1, [ys, xs + disparity], order=3, mode="nearest"
    )
    return (
        np.round(img1).astype(np.uint8),
        np.round(img2).astype(np.uint8),
        disparity,
    )


def mesh_ms(fn, mesh, reps: int) -> float:
    """Mean milliseconds per call of work spread over a mesh: one
    warm-up call, every mesh device synchronised, then `reps` calls
    between two events on the lead device's stream, the second recorded
    after the lead stream has waited for every other device's work."""
    import torch

    lead = mesh.lead
    others = [d for d in dict.fromkeys(mesh.devices) if d != lead]

    def sync_all():
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.synchronize(d)

    fn()
    sync_all()
    stream = torch.cuda.current_stream(lead)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record(stream)
    for _ in range(reps):
        fn()
    for d in others:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(d))
        stream.wait_event(done)
    t1.record(stream)
    sync_all()
    return t0.elapsed_time(t1) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card: one warm-up call, then
    `reps` calls between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs f32 operations
    over the f32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report() -> None:
    """Each kernel's registers, spills and static shared memory as ptxas
    reports them: csrc/*.cu compiled again with kernels.NVCC_FLAGS and
    -Xptxas -v, one nvcc per source, all started together."""
    from cybervision_tpu_torch import kernels

    with tempfile.TemporaryDirectory() as td:
        procs = [
            (src, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 src, "-o", os.path.join(td, os.path.basename(src) + ".o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in kernels._sources()
        ]
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v failed on {src}:\n{out}")
            fn = None
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1]
                elif fn and ("Used" in line or "spill" in line):
                    text = line.split(":", 1)[1] if line.startswith("ptxas") else line
                    print(f"ptxas {os.path.basename(src)} {fn}: {text.strip()}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# K1: the dense-correlation sweep


def _finest_prev_state(disparity, device):
    """The scale-1/2 state the finest level refines: every cell matched at
    the planted disparity, in full-resolution units."""
    import torch

    from cybervision_tpu_torch.ops.correlation import CorrelationState

    h, w = disparity.shape
    hp, wp = h // 2, w // 2
    qy, qx = np.mgrid[0:hp, 0:wp]
    x2 = np.clip(np.round(2 * qx - disparity[2 * qy, 2 * qx]), 0, w - 1)
    pos = np.stack([x2, 2 * qy], axis=-1).astype(np.int32)
    return CorrelationState(
        pos=torch.as_tensor(pos, device=device),
        corr=torch.ones((hp, wp), dtype=torch.float32, device=device),
        valid=torch.ones((hp, wp), dtype=torch.bool, device=device),
    )


def sweep_evaluations(fields: dict, axis, corridor_size, window, h2, w2,
                      min_stdev) -> tuple[int, int]:
    """Hypotheses whose 11x11 product the sweep must compute: those that
    pass every mask tested before it (source band, candidate bounds,
    corridor, p_ok, the warp's min_stdev) — the data-dependent work.
    Also, for the static forms, the (stripe, offset, tile) triples that
    the tiled kernel's block vote lets through (a tile computes the
    product for all its pixels once one admits the hypothesis); 0 for
    the per-pixel form."""
    import torch

    from cybervision_tpu_torch.ops import ncc_sweep as k1

    h, w = fields["avg1"].shape
    dev = fields["avg1"].device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    vert_b = fields["vert"] > 0.5
    off0 = torch.floor(fields["coeff"] * fields["center"] + fields["add"])
    box = k1._box11(torch.stack([fields["w0"], fields["w0"] * fields["w0"]]))
    pok = fields["p_ok"] > 0.5
    th, tw = k1.TILES.get(axis, (1, 1))
    pad = (0, -w % tw, 0, -h % th)
    total = tiles = 0
    for oi in range(fields["w0"].shape[0]):
        avg = box[0, oi] / k1.KPC
        sd = torch.sqrt(torch.clamp(box[1, oi] / k1.KPC - avg * avg, min=0.0))
        planes = torch.stack([fields["center"], off0, sd, fields["vert"]])
        for u in range(-window, window + 1):
            sh = {
                "vert": (k1.shift(planes, u, -2),
                         (rows + u >= k1.KS) & (rows + u < h - k1.KS)),
                "horiz": (k1.shift(planes, u, -1),
                          (cols + u >= k1.KS) & (cols + u < w - k1.KS)),
            }
            if axis is None:
                sl = torch.where(vert_b, sh["vert"][0], sh["horiz"][0])
                src_ok = torch.where(vert_b, sh["vert"][1], sh["horiz"][1])
            else:
                sl, src_ok = sh[axis]
            cen, off, sd_u, vert_u = sl.unbind(0)
            off = off + float(oi - corridor_size)
            is_vert = vert_b if axis is None else axis == "vert"
            qx = torch.where(is_vert, off, cen) if axis is None else (
                off if is_vert else cen)
            qy = torch.where(is_vert, cen, off) if axis is None else (
                cen if is_vert else off)
            ok = (
                src_ok & pok
                & (qx >= k1.KS) & (qx < w2 - k1.KS)
                & (qy >= k1.KS) & (qy < h2 - k1.KS)
                & (cen >= fields["start"]) & (cen < fields["end"])
                & (sd_u >= min_stdev)
            )
            if axis is None:
                ok &= (vert_u > 0.5) == vert_b
            total += int(ok.sum())
            if axis is not None:
                t = torch.nn.functional.pad(ok.float(), pad)
                tiles += int((t.reshape(-1, th, t.shape[1] // tw, tw).amax((1, 3)) > 0).sum())
    return total, tiles


def check_sweep(fields: dict, axis, kw: dict, reps: int, label: str = "") -> dict:
    """K1 against its plain version on the same fields; reps > 0 also
    times both and states the bound."""
    import torch

    from cybervision_tpu_torch.ops import ncc_sweep as k1

    args = list(fields.values())
    ck, xk, yk = k1.ncc_sweep(*args, axis=axis, **kw)
    cp, xp, yp = k1.ncc_sweep_plain(*args, axis=axis, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in ((ck, cp), (xk, xp), (yk, yp)))
    vk, vp = torch.isfinite(ck), torch.isfinite(cp)
    flip = float((vk != vp).float().mean())
    both = vk & vp
    err = float((ck - cp)[both].abs().max()) if bool(both.any()) else 0.0
    pos_eq = (
        float(((xk == xp) & (yk == yp))[both].float().mean())
        if bool(both.any()) else 1.0
    )
    valid_share = float(vp.float().mean())
    h, w = fields["avg1"].shape
    name = f"{axis or 'per-pixel'}{label}"
    if not (flip < SWEEP_FLIP_MAX and err <= SWEEP_CORR_ATOL
            and pos_eq > SWEEP_POS_EQ_MIN):
        raise AssertionError(
            f"K1 {name}: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}"
        )
    if not reps:
        print(f"K1 {name} at {h}x{w}, window {kw['window']}: valid"
              f" {valid_share:.4f}, flips {flip:.6f}, max|dcorr| {err:.3g},"
              f" positions equal {pos_eq:.6f}, bit-equal {exact}")
        return {"err": err, "exact": exact, "valid_share": valid_share}
    ms = cuda_ms(lambda: k1.ncc_sweep(*args, axis=axis, **kw), reps)
    plain_ms = cuda_ms(lambda: k1.ncc_sweep_plain(*args, axis=axis, **kw), 1)
    n_eval, n_tiles = sweep_evaluations(
        fields, axis, kw["corridor_size"], kw["window"], kw["h2"], kw["w2"],
        kw["min_stdev"],
    )
    n_o = fields["w0"].shape[0]
    # Inputs read once (the vert plane only by the per-pixel form), three
    # outputs written once.
    n_planes = 9 + (axis is None) + n_o + 3
    n_bytes = 4.0 * h * w * n_planes
    n_ops = SWEEP_OPS_PER_EVAL * n_eval + 41.0 * n_o * h * w
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"K1 {name}: valid {valid_share:.4f}, flips {flip:.6f},"
        f" max|dcorr| {err:.3g}, positions equal {pos_eq:.6f}, bit-equal"
        f" {exact}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
        f" evaluated hypotheses {n_eval}, bound {b_ms:.4f} ms ({b_by})"
        + (f"; tile votes passed {n_tiles}, i.e. {n_tiles * 4 * k1.TILE_THREADS}"
           f" pixel-hypotheses computed ({n_tiles * 4 * k1.TILE_THREADS / n_eval:.2f}x"
           f" the evaluated ones)" if n_tiles else "")
    )
    return {"err": err, "exact": exact, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "valid_share": valid_share,
            "n_eval": n_eval, "fields": fields, "axis": axis}


def sweep_case(device, axis: str, h: int, w: int, window: int | None = None):
    """K1's fields and arguments for the finest level of the synthetic SEM
    pair at h x w: rows are its epipolar lines (horizontal shift), and the
    transposed pair (w x h) has vertical ones."""
    import torch

    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode
    from cybervision_tpu_torch.ops import correlation as corr

    cc = CorrelationConfig()
    aff = ProjectionMode.AFFINE
    cs = cc.corridor_size(aff)
    a, b, d = synth_sem_pair(h, w)
    f = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)
    if axis == "vert":
        swap = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
        a, b, d, f = a.T.copy(), b.T.copy(), d.T.copy(), swap @ f @ swap
    hh, ww = a.shape
    kw = dict(
        threshold=cc.threshold(aff), min_stdev=cc.min_stdev(aff),
        window=window or cc.corridor_window_fixed, corridor_size=cs,
        h2=hh, w2=ww,
    )
    wtr, tmin = corr.split_trange(corr.warp_shift_range(f, 1.0, hh, ww, hh, ww))
    if wtr is None or wtr[0] != axis:
        raise AssertionError(f"K1 {axis}: warp bucket {wtr}")
    fields = corr.sweep_inputs(
        torch.as_tensor(a, device=device), torch.as_tensor(b, device=device),
        _finest_prev_state(d, device),
        torch.as_tensor(f, dtype=torch.float32, device=device),
        1.0, kw["min_stdev"], cc.corridor_min_range(aff),
        cc.corridor_extend_range(aff), cs, wtr, tmin, axis,
    )
    return fields, kw


def phase_sweep(device) -> dict:
    import torch

    out = {}
    for axis in ("horiz", "vert"):
        fields, kw = sweep_case(device, axis, SIZE, SIZE)
        out[axis] = check_sweep(fields, axis, kw, reps=5)
        if out[axis]["valid_share"] < 0.3:
            raise AssertionError(f"K1 {axis}: only {out[axis]['valid_share']:.3f} valid")
        if axis == "horiz":
            # Per-pixel form: the same fields with the axis flipped to
            # vertical on a checkerboard of 64-pixel blocks, so the kernel
            # chooses the sweep axis per pixel, per window element, and
            # rejects hypotheses sourced across an axis boundary.
            yy, xx = np.mgrid[0:SIZE, 0:SIZE]
            checker = ((yy // 64 + xx // 64) % 2).astype(np.float32)
            mixed = dict(fields, vert=torch.as_tensor(checker, device=device))
            out["per-pixel"] = check_sweep(mixed, None, kw, reps=3)
    return out


def phase_sweep_wide(device, mesh) -> list[dict]:
    """K1's static forms at 1024x1024 and window 192, which sweep each
    stripe's offsets in two chunks: bit-equal to the plain version and
    timed; then the row-halo form (K1s) at 192 over the mesh, bit-equal
    to its plain version and to the unsharded kernel."""
    from cybervision_tpu_torch.ops import ncc_sweep as k1

    res = []
    for axis in ("horiz", "vert"):
        fields, kw = sweep_case(device, axis, SIZE, SIZE, WIDE_WINDOW)
        chunks = k1.sweep_tile_plan(SIZE, SIZE, WIDE_WINDOW, axis)["chunks"]
        r = check_sweep(fields, axis, kw, reps=3, label=f" at window {WIDE_WINDOW}")
        print(f"K1 {axis} at window {WIDE_WINDOW}: chunks {chunks}")
        if not r["exact"]:
            raise AssertionError(f"K1 {axis} at window {WIDE_WINDOW}: not bit-equal to the plain version")
        res.append(r)
        if axis == "horiz":
            s = check_sweep_sharded(mesh, r, kw, reps=1)
            if not s["exact"]:
                raise AssertionError(f"K1s at window {WIDE_WINDOW}: not bit-equal to the plain version")
            res.append(s)
    return res


def phase_sweep_awkward(device) -> list[dict]:
    """The static forms off the tile grid (999x777) and at the window
    buckets' ends (8 and 128, on a 300x280 plane): checked, not timed."""
    res = []
    for axis in ("horiz", "vert"):
        for h, w, window in ((999, 777, None), (300, 280, 8), (300, 280, 128)):
            fields, kw = sweep_case(device, axis, h, w, window)
            res.append(check_sweep(fields, axis, kw, 0))
    return res


# ---------------------------------------------------------------------------
# K2 and K3: RANSAC scoring and sampling


def ransac_tables(matches: np.ndarray, m_bucket: int, device):
    """The main path's RANSAC inputs for a match table padded (or cut) to
    m_bucket rows: p1, p2, m_valid, the packed table and top_limit."""
    import torch

    from cybervision_tpu_torch.config import RansacConfig
    from cybervision_tpu_torch.ops.epipolar import pack_coord_table

    m = min(len(matches), m_bucket)
    mpad = np.zeros((m_bucket, 4), np.int64)
    mpad[:m] = matches[:m]
    p1 = torch.as_tensor(mpad[:, 0:2], dtype=torch.float32, device=device)
    p2 = torch.as_tensor(mpad[:, 2:4], dtype=torch.float32, device=device)
    m_valid = torch.as_tensor(np.arange(m_bucket) < m, device=device)
    packed = torch.as_tensor(pack_coord_table(mpad), device=device)
    return p1, p2, m_valid, packed, min(m, RansacConfig().top_inliers)


def check_score(matches, m_bucket, device, gen, c=BATCH, mask="",
                reps=5) -> dict:
    """K2 against its plain version: counts equal, sums within rtol 1e-5.
    mask "holes" clears rows in the middle of the valid ones, "none"
    clears them all; reps > 0 also times both and states the bound."""
    import torch

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops import score as k2
    from cybervision_tpu_torch.ops.epipolar import solve_affine_batch

    rc = RansacConfig()
    t = rc.params(ProjectionMode.AFFINE)[2]
    p1, p2, m_valid, _, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(0, top_limit, (c, 4), generator=gen, device=device)
    ff, _ = solve_affine_batch(p1[idx], p2[idx], rc.rank_epsilon)
    ff = ff.contiguous()
    if mask == "holes":
        n = int(m_valid.sum())
        m_valid = m_valid.clone()
        m_valid[n // 5 : n // 5 + 700] = False
        m_valid[n // 2 : n // 2 + 31] = False
    elif mask == "none":
        m_valid = torch.zeros_like(m_valid)
    ck, sk = k2.score_candidates(ff, p1, p2, m_valid, t)
    cp, sp = k2.score_candidates_plain(ff, p1, p2, m_valid, t)
    torch.cuda.synchronize()
    label = f"K2 C={c} M={m_bucket}{' mask ' + mask if mask else ''}"
    if not torch.equal(ck, cp):
        raise AssertionError(f"{label}: {int((ck != cp).sum())} counts differ")
    if not torch.allclose(sk, sp, rtol=SCORE_RTOL, atol=0.0):
        raise AssertionError(f"{label}: error sums beyond rtol {SCORE_RTOL}")
    if mask == "none" and (int(ck.abs().sum()) or float(sk.abs().sum())):
        raise AssertionError(f"{label}: counts or sums not 0")
    err = float((sk - sp).abs().max())
    if not reps:
        print(f"{label}: counts equal (max {int(ck.max())}), max|dsum| {err:.3g}")
        return {"err": err}
    ms = cuda_ms(lambda: k2.score_candidates(ff, p1, p2, m_valid, t), reps)
    plain_ms = cuda_ms(
        lambda: k2.score_candidates_plain(ff, p1, p2, m_valid, t), 1
    )
    # Sampson error per (candidate, valid match): 5 linear forms (4 ops
    # each), the bilinear form (4), its square (1), the denominator (7),
    # the quotient (1), the threshold test and the masked sum (3). Rows
    # whose mask is clear need no work.
    m_work = int(m_valid.sum())
    n_ops = 36.0 * c * m_work
    n_bytes = c * 9 * 4 + m_bucket * (4 * 4 + 1) + c * 8
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"{label}: counts equal (max {int(ck.max())}),"
        f" max|dsum| {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}, {m_work} valid rows)"
    )
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_gather(matches, m_bucket, device, gen) -> dict:
    import torch

    from cybervision_tpu_torch.ops import gather as k3

    _, _, _, packed, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(
        0, top_limit, (DRAW_ROUNDS, 4, BATCH), generator=gen, device=device,
        dtype=torch.int32,
    )
    out_k = k3.gather_packed(packed, idx)
    out_p = k3.gather_packed_plain(packed, idx)
    flat = idx.reshape(-1)
    out_l = torch.index_select(packed, 1, flat).reshape(out_p.shape)
    out_pub = gather_public_path(packed, idx)
    torch.cuda.synchronize()
    if not all(torch.equal(o, out_p) for o in (out_k, out_l, out_pub)):
        raise AssertionError(f"K3 M={m_bucket}: gathers differ")
    calls = {"kernel": lambda: k3.gather_packed(packed, idx),
             "library": lambda: torch.index_select(packed, 1, flat)}
    # The kernel and index_select in turns, 200 calls a turn: at tens of
    # microseconds a call, separate runs measure the host as much as the
    # card.
    turns = {"kernel": [], "library": []}
    for _ in range(GATHER_TURNS):
        for who, fn in calls.items():
            turns[who].append(cuda_ms(fn, 200))
    ms = float(np.median(turns["kernel"]))
    lib_ms = float(np.median(turns["library"]))
    dev_us = gather_device_us(calls)
    # Host time also of the same launch through the public host path
    # (gather_public_path): what the wrapper's trimmed path saves.
    host_calls = dict(calls, public=lambda: gather_public_path(packed, idx))
    host = {who: [] for who in host_calls}
    for _ in range(GATHER_TURNS):
        for who, fn in host_calls.items():
            host[who].append(host_us(fn, GATHER_HOST_CALLS))
    host_med = {who: tuple(float(np.median([t[i] for t in v])) for i in range(2))
                for who, v in host.items()}
    plain_ms = cuda_ms(lambda: k3.gather_packed_plain(packed, idx), 20)
    k = idx.numel()
    n_bytes = 4.0 * k + 4.0 * packed.numel() + 8.0 * k
    b_ms, b_by = bound_ms(n_bytes, 0.0)
    print(
        f"K3 M={m_bucket}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_select {lib_ms:.4f} ms (CUDA events around 200 calls, medians"
        f" of {GATHER_TURNS} turns: kernel {[round(x, 5) for x in turns['kernel']]},"
        f" index_select {[round(x, 5) for x in turns['library']]}), bound"
        f" {b_ms:.4f} ms ({b_by})"
    )
    print(
        f"K3 M={m_bucket} per call: device {dev_us['kernel']['mean']:.3f} us"
        f" (events {dev_us['kernel']['events']}, median {dev_us['kernel']['median']:.3f})"
        f" vs index_select {dev_us['library']['mean']:.3f} us (events"
        f" {dev_us['library']['events']}, median {dev_us['library']['median']:.3f},"
        f" kernels {dev_us['library']['names']}); host {host_med['kernel'][0]:.3f} us"
        f" to enqueue, {host_med['kernel'][1]:.3f} us with the queue drained, vs"
        f" index_select {host_med['library'][0]:.3f} / {host_med['library'][1]:.3f} us,"
        f" public host path {host_med['public'][0]:.3f} / {host_med['public'][1]:.3f} us"
        f" (medians of {GATHER_TURNS} turns of {GATHER_HOST_CALLS} calls: kernel"
        f" {[round(t[0], 3) for t in host['kernel']]}, index_select"
        f" {[round(t[0], 3) for t in host['library']]}, public host path"
        f" {[round(t[0], 3) for t in host['public']]})"
    )
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "device_us_per_call": dev_us["kernel"]["mean"],
            "library_device_us_per_call": dev_us["library"]["mean"],
            "host_us_per_call": host_med["kernel"][0],
            "library_host_us_per_call": host_med["library"][0],
            "public_host_us_per_call": host_med["public"][0]}


def gather_public_path(table, idx):
    """K3's launch through PyTorch's public host API, for timing beside
    ops.gather.gather_packed: the library looked up per call, a
    torch.cuda.device context and a torch.cuda.Stream object for the
    stream, around the same C entry point. Counts no launch."""
    import torch

    from cybervision_tpu_torch import kernels

    lib = kernels.library()
    tbl = table.contiguous()
    flat = idx.contiguous()
    out = torch.empty((2,) + tuple(idx.shape), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        kernels.check(
            lib.cv_gather_packed(
                tbl.data_ptr(), tbl.shape[1], flat.data_ptr(), flat.numel(),
                out.data_ptr(), torch.cuda.current_stream(idx.device).cuda_stream,
            ),
            "cv_gather_packed",
        )
    return out


def host_us(fn, calls: int) -> tuple[float, float]:
    """Host microseconds per call: perf_counter around `calls` calls with
    no sync (the time to enqueue them), and with the queue drained."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def gather_device_us(calls: dict) -> dict:
    """Device microseconds per call of K3 ("kernel") and index_select
    ("library"), from one torch.profiler profile that runs them in turns
    (GATHER_TURNS turns of GATHER_PROFILED_CALLS calls, a sync between
    turns): the device events of K3's kernel, and every other device
    event (index_select's kernels), summed over each one's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(GATHER_TURNS):
            for fn in calls.values():
                for _ in range(GATHER_PROFILED_CALLS):
                    fn()
                torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for who in calls:
        mine = [e for e in kernels
                if any(k in e.name for k in KERNEL_NAMES["gather_packed"]) == (who == "kernel")]
        durs = [e.time_range.end - e.time_range.start for e in mine]
        n_calls = GATHER_TURNS * GATHER_PROFILED_CALLS
        out[who] = {"mean": sum(durs) / n_calls if durs else float("nan"),
                    "median": float(np.median(durs)) if durs else float("nan"),
                    "events": len(durs), "names": sorted({e.name[:40] for e in mine})}
    return out


def check_draws(device) -> dict:
    """One RANSAC round's draws, utils.prng.randint((13, 4, 50,000)) from a
    round key: equal on the card and on the CPU; ms per call beside
    torch.randint, the draw the threefry port replaced."""
    import torch

    from cybervision_tpu_torch.utils import prng

    key = prng.split(prng.prng_key(0))[1]
    shape = (DRAW_ROUNDS, 4, BATCH)
    top = 13_066
    out = prng.randint(key, shape, 0, top, device=device)
    same = torch.equal(out.cpu(), prng.randint(key, shape, 0, top))
    ms = cuda_ms(lambda: prng.randint(key, shape, 0, top, device=device), 20)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    old_ms = cuda_ms(lambda: torch.randint(0, top, shape, generator=gen, device=device,
                                           dtype=torch.int32), 20)
    print(f"draws of one RANSAC round {shape}: card equals CPU {same};"
          f" threefry {ms:.4f} ms per call vs torch.randint {old_ms:.4f} ms")
    if not same:
        raise AssertionError("the card's threefry draws differ from the CPU's")
    return {"ms": ms, "torch_randint_ms": old_ms}


def phase_ransac_all_rounds(matches, device, counters) -> dict:
    """find_fundamental_matrix on the main path's matches with an early
    exit no count reaches (RansacConfig.ransac_d_early_exit_affine above
    the match count), so every one of the 1,000,000 / 50,000 = 20 rounds
    runs: seconds (best of 2 warm runs), K2 and K3 launches per run (set
    to 0 just before, read just after), and their device milliseconds in
    one more run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix

    cfg = RansacConfig(ransac_d_early_exit_affine=10**9)
    aff = ProjectionMode.AFFINE
    rounds = cfg.ransac_k_affine // cfg.check_interval
    secs, res = [], None
    for _ in range(2):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        res = find_fundamental_matrix(matches, aff, float(SIZE), cfg, device=device, mesh=None)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        find_fundamental_matrix(matches, aff, float(SIZE), cfg, device=device, mesh=None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    dev_ms = {name: sum(e.self_device_time_total for e in averages
                        if any(k in e.key for k in KERNEL_NAMES[name])) / 1e3
              for name in counters}
    busy = device_busy_us(prof)[0] / 1e3
    print(f"RANSAC, all {rounds} rounds (no early exit): best of 2 {min(secs):.4f} s"
          f" (runs {[round(x, 4) for x in secs]}), launches {launches}; profiled run:"
          f" wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, device ms by wrapper"
          f" {json.dumps(dev_ms)}; winner {res.matches_count} inliers of"
          f" {len(matches)} matches")
    for name, n in launches.items():
        if n != rounds:
            raise AssertionError(f"{name} launched {n} times in {rounds} rounds")
    return {"seconds": min(secs), "launches": launches, "device_ms": dev_ms}


def main_path_matches(img1, img2, device) -> np.ndarray:
    """The sparse phase of the main path (ORB + matching, no kernel), for
    the RANSAC kernels' inputs."""
    from cybervision_tpu_torch.config import ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.ops.features import extract_keypoints_pyramid_packed
    from cybervision_tpu_torch.ops.matching import match_keypoints_packed

    cfg = ReconstructionConfig()
    p1, p2 = extract_keypoints_pyramid_packed([img1, img2], cfg.orb, device)
    matches, _, _ = match_keypoints_packed(
        p1, p2, cfg.matching.threshold(ProjectionMode.AFFINE)
    )
    return matches


# ---------------------------------------------------------------------------
# Phase 4: the multi-device path


SHARDS_ON_ONE_CARD = 4


def chip_mesh():
    """Every visible card when there are two or more, else four row
    shards on the one card."""
    import torch

    from cybervision_tpu_torch.parallel import Mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device("cuda", 0),) * SHARDS_ON_ONE_CARD)


def check_sweep_sharded(mesh, swept: dict, kw: dict, reps: int) -> dict:
    """K1s on phase 2's fields of one form: exactly the unsharded K1, and
    its sharded plain version within K1's tolerances; timed with the
    halo exchange."""
    import torch

    from cybervision_tpu_torch.ops import ncc_sweep as k1
    from cybervision_tpu_torch.parallel import gather_rows

    fields, axis = swept["fields"], swept["axis"]
    args = list(fields.values())
    lead = mesh.lead

    def run(plain=False):
        return [gather_rows(o, lead) for o in k1.ncc_sweep_sharded(
            mesh, *args, axis=axis, plain=plain, **kw)]

    single = k1.ncc_sweep(*args, axis=axis, **kw)
    out = run()
    ref = run(plain=True)
    for d in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(d)
    name = axis or "per-pixel"
    v1, v0 = torch.isfinite(out[0]), torch.isfinite(single[0])
    flips = int((v1 != v0).sum())
    both = v1 & v0
    d_corr = float((out[0] - single[0])[both].abs().max()) if bool(both.any()) else 0.0
    pos_same = bool(torch.equal(out[1], single[1]) and torch.equal(out[2], single[2]))
    if not (flips == 0 and torch.equal(out[0], single[0]) and pos_same):
        raise AssertionError(
            f"K1s {name}: not equal to the unsharded K1 ({flips} valid flips,"
            f" max|dcorr| {d_corr:.3g}, positions equal {pos_same})"
        )
    exact = all(torch.equal(a, b) for a, b in zip(out, ref))
    vp = torch.isfinite(ref[0])
    flip = float((v1 != vp).float().mean())
    both = v1 & vp
    err = float((out[0] - ref[0])[both].abs().max()) if bool(both.any()) else 0.0
    pos_eq = (
        float(((out[1] == ref[1]) & (out[2] == ref[2]))[both].float().mean())
        if bool(both.any()) else 1.0
    )
    if not (flip < SWEEP_FLIP_MAX and err <= SWEEP_CORR_ATOL
            and pos_eq > SWEEP_POS_EQ_MIN):
        raise AssertionError(
            f"K1s {name} vs plain: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}"
        )
    ms = mesh_ms(lambda: k1.ncc_sweep_sharded(mesh, *args, axis=axis, **kw), mesh, reps)
    plain_ms = mesh_ms(
        lambda: k1.ncc_sweep_sharded(mesh, *args, axis=axis, plain=True, **kw), mesh, 1
    )
    h, w = fields["avg1"].shape
    n_o = fields["w0"].shape[0]
    n, hs = mesh.size, -(-h // mesh.size)
    m_w0 = k1.KS + kw["window"]
    # K1's work (phase 2) plus the halo exchange: per shard, KS rows of
    # img1 above and below, `window` of vert/center/coeff/add, KS + window
    # of every stripe's warp, each read once and written once; and the
    # warp box sums over every shard's haloed planes.
    halo_rows = 2 * k1.KS + 4 * 2 * kw["window"] + n_o * 2 * m_w0
    n_bytes = 4.0 * h * w * (9 + (axis is None) + n_o + 3) + 8.0 * w * n * halo_rows
    n_ops = SWEEP_OPS_PER_EVAL * swept["n_eval"] + 41.0 * n_o * n * (hs + 2 * m_w0) * w
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"K1s {name} over {mesh.describe()}, window {kw['window']}: equal to K1"
        f" (0 flips, |dcorr| 0, positions equal); vs sharded plain: flips"
        f" {flip:.6f}, max|dcorr| {err:.3g}, positions equal {pos_eq:.6f},"
        f" bit-equal {exact};"
        f" {ms:.3f} ms per call with the halo exchange, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by})"
    )
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "exact": exact}


def phase_mesh_sweep(mesh, sweep: dict) -> dict:
    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode

    cc = CorrelationConfig()
    aff = ProjectionMode.AFFINE
    kw = dict(
        threshold=cc.threshold(aff), min_stdev=cc.min_stdev(aff),
        window=cc.corridor_window_fixed, corridor_size=cc.corridor_size(aff),
        h2=SIZE, w2=SIZE,
    )
    return {form: check_sweep_sharded(mesh, swept, kw, reps=3)
            for form, swept in sweep.items()}


def check_mesh_launches(e2e: dict, n: int) -> None:
    """Launches of a run under an n-shard mesh against its plan: two
    sweeps (forward, reverse) per refine level, n K1 launches for each
    sharded one; K2 and K3 once per shard per RANSAC round."""
    levels = e2e["plan"]["sharded_levels"][1:]
    sharded = 2 * sum(levels)
    single = 2 * (len(levels) - sum(levels))
    got = e2e["launches"]
    if not (e2e["plan"]["mesh"] and got["ncc_sweep_sharded"] == sharded > 0):
        raise AssertionError(f"sharded sweeps {got['ncc_sweep_sharded']}, plan {e2e['plan']}")
    if got["ncc_sweep"] != n * sharded + single:
        raise AssertionError(f"K1 launched {got['ncc_sweep']} times, want {n * sharded + single}")
    for name in ("score_candidates", "gather_packed"):
        if got[name] == 0 or got[name] % n:
            raise AssertionError(f"{name} launched {got[name]} times over {n} shards")


def phase_same_correlation(img1, img2, matches, mesh, device) -> None:
    """correlate_images under the mesh for the F of an unsharded RANSAC
    run: its delta and word planes equal the unsharded run's."""
    import torch

    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix

    aff = ProjectionMode.AFFINE
    f = find_fundamental_matrix(matches, aff, float(SIZE), device=device, mesh=None).f
    src = [SourceImage(im) for im in (img1, img2)]
    cc = CorrelationConfig()
    single = correlation.correlate_images(
        *src, f, aff, cc, device_out="delta", device=device, mesh=None)
    sharded = correlation.correlate_images(
        *src, f, aff, cc, device_out="delta", device=device, mesh=mesh)
    plan = correlation._LAST_PLAN
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(single, sharded))
    valid = float(((single[0] >> 14) & 1).float().mean())
    print(f"correlate_images under the mesh, F of an unsharded run: delta and"
          f" word planes equal {same} (valid share {valid:.4f}, plan {plan})")
    if not (same and plan["mesh"] and any(plan["sharded_levels"])):
        raise AssertionError("the sharded correlation differs from the unsharded one")


# ---------------------------------------------------------------------------
# End to end


def read_ply_vertices(path: str) -> np.ndarray:
    """(N, 3) float64 vertex coordinates of the native writer's binary
    big-endian PLY (x, y, z doubles, then r, g, b bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    head, _, body = data.partition(b"end_header\n")
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    rec = np.frombuffer(
        body[: n * 27], dtype=[("xyz", ">f8", 3), ("rgb", "u1", 3)]
    )
    return rec["xyz"].astype(np.float64)


def phase_end_to_end(img1, img2, disparity, counters, mesh=None,
                     label="end to end") -> dict:
    """The main path through reconstruct, under `mesh` (None: the
    single-card path). counters: kernel name -> (module, attribute) of
    its launch count, each set to 0 just before a timed run and read
    just after it."""
    import torch

    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.parallel import use_mesh
    from cybervision_tpu_torch.reconstruction import reconstruct

    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    # In memory, the colour plane is the gray one repeated: PIL's
    # convert("RGB") of an "L" image.
    images = [SourceImage(im) for im in (img1, img2)]
    names = ["synth_a.png", "synth_b.png"]
    runs = []
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, "mesh.ply")
        t0 = time.perf_counter()
        reconstruct(names, out, cfg, quiet=True, images=images)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        for _ in range(3):
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            phases = reconstruct(names, out, cfg, quiet=True, images=images)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            dt = time.perf_counter() - t0
            launches = {name: getattr(mod, attr)
                        for name, (mod, attr) in counters.items()}
            runs.append((dt, phases, launches))
        xyz = read_ply_vertices(out)
    plan = dict(correlation._LAST_PLAN)
    best_s, phases, launches = min(runs, key=lambda r: r[0])
    if any(r[2] != runs[0][2] for r in runs):
        raise AssertionError(f"launch counts vary between runs: {[r[2] for r in runs]}")
    print(f"{label}: cold {cold_s:.3f} s, warm best of 3 {best_s:.3f} s"
          f" (runs {[round(r[0], 4) for r in runs]})")
    print("phases of the best run: " + json.dumps(
        {k: round(v, 4) for k, v in phases.items()}))
    print(f"launches per run: {launches}; correlation plan {plan}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")

    n = len(xyz)
    share = n / float(SIZE * SIZE)
    xs = np.clip(np.round(xyz[:, 0]).astype(int), 0, SIZE - 1)
    ys = np.clip(np.round(-xyz[:, 1]).astype(int), 0, SIZE - 1)
    depth = -xyz[:, 2]  # the default --scale=-1 flips z
    truth = disparity[ys, xs]
    r = float(np.corrcoef(depth, truth)[0, 1])
    med = float(np.median(np.abs(depth - truth)))
    print(f"PLY: {n} vertices ({share:.3f} of the pixels), depth vs planted"
          f" disparity: r {r:.4f}, median |err| {med:.3f} px")
    if not np.all(np.isfinite(xyz)):
        raise AssertionError("non-finite vertices")
    if share <= 0.3:
        raise AssertionError(f"only {share:.3f} of the pixels became vertices")
    if r < 0.9 or med > 1.0:
        raise AssertionError(f"depth does not track the disparity (r {r:.3f}, median {med:.3f})")
    return {"seconds": best_s, "launches": launches, "plan": plan, "phases": phases}


def device_busy_us(prof) -> tuple[float, int]:
    """Microseconds in which the card ran at least one kernel during a
    profiled window (the union of its device events), and their count."""
    import torch

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, len(spans)


def profile_end_to_end(img1, img2, mesh=None, label="profile") -> dict:
    """One warm main-path run under torch.profiler (under `mesh`; None:
    the single-card path): the card's busy share of the run (union of
    device-event intervals over the host wall time), the ops by self
    device time, and each wrapper's kernels' device milliseconds in the
    run (KERNEL_NAMES)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.parallel import use_mesh
    from cybervision_tpu_torch.reconstruction import reconstruct

    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    images = [SourceImage(im) for im in (img1, img2)]
    names = ["synth_a.png", "synth_b.png"]
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, "mesh.ply")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reconstruct(names, out, cfg, quiet=True, images=images)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_events = device_busy_us(prof)
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms"
          f" ({busy / wall_us:.4f} of the run), {n_events} device events")
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=15))
    per_kernel = {
        name: sum(e.self_device_time_total for e in averages
                  if any(k in e.key for k in keys)) / 1e3
        for name, keys in KERNEL_NAMES.items()
    }
    print(f"{label}: device ms per run by wrapper {json.dumps(per_kernel)}")
    return per_kernel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 1
    from cybervision_tpu_torch import kernels
    from cybervision_tpu_torch.ops import gather, ncc_sweep, score
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda};"
          f" fp32 matmul TF32 {torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: first_pass needs full fp32")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    ptxas_report()

    t0 = time.perf_counter()
    sweep = phase_sweep(device)
    awkward = phase_sweep_awkward(device)
    img1, img2, disparity = synth_sem_pair(SIZE, SIZE)
    matches = main_path_matches(img1, img2, device)
    m_main = pow2_bucket(len(matches), floor=2048, factor=4)
    print(f"main path: {len(matches)} matches, RANSAC table M = {m_main}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    sizes = sorted({8192, m_main})
    score_r = {m: check_score(matches, m, device, gen) for m in sizes}
    score_awkward = [
        check_score(matches, m_main, device, gen, c=BATCH + 1, mask=mask, reps=0)
        for mask in ("holes", "none")
    ]
    gather_r = {m: check_gather(matches, m, device, gen) for m in sizes}
    draws = check_draws(device)
    mesh = chip_mesh()
    wide = phase_sweep_wide(device, mesh)
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    counters = {"ncc_sweep": (ncc_sweep, "launches"),
                "score_candidates": (score, "launches"),
                "gather_packed": (gather, "launches")}
    e2e = phase_end_to_end(img1, img2, disparity, counters)
    print("RANSAC phase of the best run, threefry draws:"
          f" {e2e['phases']['Completed RANSAC fitting']} s")
    device_ms = profile_end_to_end(img1, img2)
    ransac_full = phase_ransac_all_rounds(
        matches, device, {k: counters[k] for k in ("score_candidates", "gather_packed")})

    t0 = time.perf_counter()
    print(f"mesh: {mesh.describe()} ("
          + ("every visible card" if len(set(mesh.devices)) > 1 else
             "row shards on one card: the only card visible") + ")")
    sharded = phase_mesh_sweep(mesh, sweep)
    e2e_mesh = phase_end_to_end(
        img1, img2, disparity,
        dict(counters, ncc_sweep_sharded=(ncc_sweep, "sharded_launches")),
        mesh=mesh, label="end to end under the mesh",
    )
    check_mesh_launches(e2e_mesh, mesh.size)
    device_ms_mesh = profile_end_to_end(img1, img2, mesh, "profile under the mesh")
    phase_same_correlation(img1, img2, matches, mesh, device)
    print(f"multi-device phase took {time.perf_counter() - t0:.1f} s")

    def record(name, source, replaces, main, errs, run=e2e, dev_ms=device_ms,
               dev_name=None):
        return {
            "name": name, "route": "cuda",
            "source": f"cybervision_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": run["launches"][name],
            "max_abs_err": max(errs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            # Device time of the wrapper's kernels in one profiled e2e run.
            "device_ms_per_run": dev_ms[dev_name or name],
        }

    kernels_line = {"kernels": [
        record("ncc_sweep", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:93", sweep["horiz"],
               [r["err"] for r in [*sweep.values(), *awkward, *wide]]),
        record("score_candidates", "score_candidates.cu",
               "cybervision_tpu/ops/pallas_score.py:56", score_r[m_main],
               [r["err"] for r in [*score_r.values(), *score_awkward]]),
        dict(record("gather_packed", "gather_packed.cu",
                    "cybervision_tpu/ops/pallas_gather.py:60", gather_r[m_main],
                    [r["err"] for r in gather_r.values()]),
             **{k: gather_r[m_main][k] for k in (
                 "device_us_per_call", "library_device_us_per_call",
                 "host_us_per_call", "library_host_us_per_call")}),
        record("ncc_sweep_sharded", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:682", sharded["horiz"],
               [r["err"] for r in sharded.values()], run=e2e_mesh,
               dev_ms=device_ms_mesh, dev_name="ncc_sweep"),
    ]}
    print(f"end-to-end seconds (warm, best of 3): {e2e['seconds']:.4f} on one"
          f" card, {e2e_mesh['seconds']:.4f} over {mesh.describe()}; RANSAC"
          f" of all 20 rounds {ransac_full['seconds']:.4f} s; one round's draws"
          f" {draws['ms']:.4f} ms (torch.randint {draws['torch_randint_ms']:.4f} ms)")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
