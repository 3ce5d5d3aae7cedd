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
                     (main path), "vert" and per-pixel forms (the last on
                     a checkerboard of axes in 64-pixel squares);
                     tolerances of tests/test_pallas_ncc.py (under 0.5 %
                     of valid flags differ, corr within 1e-4, over 99.5 %
                     of positions equal), the per-pixel form bit for bit;
                     also all three forms at 999x777 (no multiple of a
                     tile) and at windows 8 and 128 on a 300x280 plane,
                     the per-pixel one with its axis flipping across the
                     diagonal; the per-pixel form prints its tile votes
                     and the tiles that stage one band of the warp or two;
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
     K1 wide       — all three forms at 1024x1024 and window 192 (in
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
   its sharded plain version within K1's tolerances (the per-pixel form
   bit for bit); its time includes the halo exchange. Then the main path end to end under the mesh (a
   warm-up and three timed runs, phase 3's gates, the launches per run
   checked against the plan: one K1 per shard on each sharded level,
   one K2 and one K3 per shard per RANSAC round; every pyramid level
   whose rows shard ran row-sharded from resize to cross-check), one
   more run under the profiler for K1s's device milliseconds per run,
   and correlate_images under the mesh for the F of an unsharded run,
   whose delta plane must equal the unsharded one.
5. Affine lanes, on one card, through reconstruction.reconstruct:
   BASELINE #1 — the 1024x1024 pair to a PNG depth map with
   interpolation none (the fast lane): a cold run, best of 3 warm runs,
   one profiled run (busy share); gates read back from the PNG with
   this script's own zlib decoder: over 30 % of the pixels opaque,
   exactly the pixels that phase 3's PLY has as vertices, and the depth
   through the nearest colour-table entry tracks the planted disparity
   (|r| >= 0.9). BASELINE #4 — a 4032x3024 pair to a texture-coordinates
   OBJ with --max-points 500,000 (the word lane, subsampled on the
   card): one warm-up run; then K1 in both static forms at the full-
   resolution level's window at 4032x3024 (bit-equal), K2 and K3 at the
   pair's match table against their plain versions, timed; then best
   of 2 timed runs and one profiled run. Gates: min(500,000, valid
   pixels) vertices, each at a valid pixel with the dense result's
   exact depth (one correlate_images run for the same F), faces, both
   texture PNGs equal to the images, and the depth tracking the planted
   disparity (r >= 0.9).
6. The perspective path, on one card, through
   reconstruction.Reconstruction with the default RANSAC budgets (20
   rounds of 50,000 samples a pair, no early exit): tests/
   perspective_scene.py's renderer, copied (render_perspective), with K
   scaled with the image. BASELINE #3 — 2 views of 320x256 to an OBJ
   (Delaunay, vertex colours, bundle adjustment), the 35 mm focal length
   43 on the in-memory images as the EXIF tag would give it; BASELINE
   #5 — 3 views to a merged PLY with --focal-length 43; the same 3-view
   scene at 1024x820; a diagonal pair at 1024x820 to an OBJ (camera 2
   translated along both image axes at once, K the one 43 mm gives),
   whose epipolar lines cross the image at 38-54 degrees, so that no
   level has a uniform sweep axis and K1 runs its per-pixel form. Each:
   a warm-up run, best of 2 (1 for the 3 views at 1024x820, 2 for the
   diagonal pair) with launches per run (K1's
   per-pixel form apart), grouped phase seconds, peak device memory,
   then one profiled run (busy share, top kernels by device time).
   Gates: no RANSAC or dense
   failure but the 3-view scene's pair of views 2-3 (the JAX package
   proves it unlinkable at the default floor), every view recovered with
   its rotation and translation direction near the renderer's after
   aligning camera 1 (POSE_TOL_DEG; BASELINE #5 at the JAX package's own
   errors on that scene plus POSE_MARGIN_DEG), every point in front of
   the cameras that see it, depth seen from camera 1 tracking the
   renderer's (r >= 0.9), the JAX tests' vertex and face floors, and K1's
   per-pixel form launched in the diagonal run. The DLT's host float64
   eigh and its card eigh + host polish are timed on each run's smallest
   and largest triangulation. Then K1's per-pixel form on the diagonal
   run's finest-level fields, K2 at C = 150,000 candidates of the
   7-point solver and K3 at (13, 7, 50,000) on the 3-view full-width
   run's largest pair table, each against its plain version, timed with
   its bound.
7. The perspective path under phase 4's mesh: BASELINE #5 (P3P
   candidates scored in one block per shard: blocks = shards x sharded
   calls) and the diagonal pair (every K1 launch the per-pixel form,
   n per sharded sweep), each a warm-up, best of 2 and one profiled run
   with phase 6's gates and the correlation plan; then the diagonal
   pair's correlate_images for the F of phase 6's unsharded run, under
   the mesh and without it, equal bit for bit.

Every phase prints the launches of K1/K2/K3 per run (counts set to 0
just before a run, read just after). The last two lines of standard
output are one JSON object per kernel record ({"kernels": [...]}) and
the device record ({"ok": true, ...}).
The script exits non-zero, printing neither, when there is no CUDA device
or any phase fails. It imports nothing of JAX and nothing of the JAX
package, and needs no Pillow: images are built in memory.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
from scipy import ndimage

SIZE = 1024
BATCH = 50_000  # RansacConfig.check_interval: candidates per RANSAC round
DRAW_ROUNDS = 13  # redraw rounds of _ransac_batch_core's sampling
GATHER_TURNS = 5
GATHER_PROFILED_CALLS = 50  # per turn, in the one profile
GATHER_HOST_CALLS = 1000  # per turn, timed on the host clock
WIDE_WINDOW = 192  # two chunks of offsets per stripe in K1's static forms
LARGE_H, LARGE_W = 3024, 4032  # BASELINE #4's pair: 12.2 Mpx
MAX_POINTS = 500_000  # BASELINE #4's --max-points
# Phase 6: tests/perspective_scene.py's views, focal length in pixels
# and extra cameras (pair_cam, third_cam: axis-angle rotation and
# translation; camera 1 is the identity), 43 mm as the 35 mm equivalent
# of its 400 px, and the full-width scale (1024x820).
PERSP_W, PERSP_H = 320, 256
PERSP_F = 400.0
PERSP_FOCAL_35MM = 43
PERSP_CAMS = (
    ((0.02, 0.12, -0.01), (1.2, 0.1, 0.2)),
    ((-0.015, -0.1, 0.012), (-1.1, -0.12, 0.15)),
)
FULL_SCALE = 3.2
# Phase 6's diagonal pair: camera 2 translated along both image axes at
# once, so the epipoles lie off the lower-right corner ((3564, 3437) and (3925, 3610)
# at 1024x820) and the epipolar lines cross the image at 38-54 degrees:
# the dominant axis changes across every level, none has a uniform sweep
# axis, and K1 runs its per-pixel form.
PERSP_CAM_DIAGONAL = ((0.03, 0.06, -0.01), (0.8, 0.75, 0.3))
# Camera pose gates, degrees: rotation and translation direction against
# the renderer's after aligning camera 1.
POSE_TOL_DEG = (1.0, 3.0)
# BASELINE #5 is held to the JAX package's own result on that scene at
# the default budgets (tools/baseline5_reference.py on the CPU), per extra
# camera, plus POSE_MARGIN_DEG: there the budget's F for views 1-2 puts
# the epipole 30.8 deg off before the dense phase, the pair of views 2-3
# fails at the default floor and bundle adjustment ends at these errors.
POSE_REF_BASELINE5 = ((1.318, 3.971), (1.073, 8.971))
POSE_MARGIN_DEG = 0.5
# The DLT's host float64 eigh against the card's float32 eigh + float64
# polish: largest relative gap of a dehomogenised point.
DLT_AGREE_REL = 1e-6
DEPTH_R_MIN = 0.9
# Device kernels of each wrapper, as the profiler names them.
KERNEL_NAMES = {
    "ncc_sweep": ("sweep_tile_kernel", "sweep_pixel_tile_kernel"),
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


@functools.lru_cache(maxsize=2)
def synth_sem_pair(h: int, w: int, seed: int = 0):
    """The bench's synthetic SEM pair (a copy of bench.synth_sem_pair) plus
    its planted disparity: img2(x, y) = img1(x + d, y). Cached (the
    12.2-Mpx pair takes seconds to make); callers do not write to it."""
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
                      min_stdev) -> dict:
    """What the sweep computes on these fields. n_eval: the hypotheses
    whose 11x11 product the sweep must compute, those that pass every mask
    tested before it (source band, candidate bounds, corridor, p_ok, the
    warp's min_stdev) — the data-dependent work. tile_votes: the (stripe,
    offset, tile) triples that the tiled kernel's block vote lets through
    (a tile computes the product for all its pixels once one admits the
    hypothesis). For the per-pixel form also the tiles that stage one
    band of w0 or two: those with a pixel that passes the masks that hold
    for every stripe, by the axes among their elements (the tile +- KS
    inside the plane)."""
    import torch
    import torch.nn.functional as F

    from cybervision_tpu_torch.ops import ncc_sweep as k1

    ks = k1.KS
    h, w = fields["avg1"].shape
    dev = fields["avg1"].device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    vert_b = fields["vert"] > 0.5
    off0 = torch.floor(fields["coeff"] * fields["center"] + fields["add"])
    box = k1._box11(torch.stack([fields["w0"], fields["w0"] * fields["w0"]]))
    pok = fields["p_ok"] > 0.5
    th, tw = k1.TILES[axis]
    pad = (0, -w % tw, 0, -h % th)

    def per_tile(m):
        t = F.pad(m.float(), pad)
        return t.reshape(-1, th, t.shape[1] // tw, tw).amax((1, 3)) > 0

    total = tiles = 0
    base_any = per_tile(torch.zeros_like(pok))
    for oi in range(fields["w0"].shape[0]):
        avg = box[0, oi] / k1.KPC
        sd = torch.sqrt(torch.clamp(box[1, oi] / k1.KPC - avg * avg, min=0.0))
        planes = torch.stack([fields["center"], off0, sd, fields["vert"]])
        for u in range(-window, window + 1):
            sh = {
                "vert": (k1.shift(planes, u, -2),
                         (rows + u >= ks) & (rows + u < h - ks)),
                "horiz": (k1.shift(planes, u, -1),
                          (cols + u >= ks) & (cols + u < w - ks)),
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
            base = src_ok & pok & (cen >= fields["start"]) & (cen < fields["end"])
            if axis is None:
                # The masks that hold for every stripe, as the kernel's
                # first vote tests them.
                base &= ((vert_u > 0.5) == vert_b) & (cen >= ks) & (
                    cen < torch.where(vert_b, h2, w2) - ks)
                if oi == 0:
                    base_any |= per_tile(base)
            ok = (
                base
                & (qx >= ks) & (qx < w2 - ks)
                & (qy >= ks) & (qy < h2 - ks)
                & (sd_u >= min_stdev)
            )
            total += int(ok.sum())
            tiles += int(per_tile(ok).sum())
    out = {"n_eval": total, "tile_votes": tiles}
    if axis is None:
        # Axes among each tile's elements inside the plane: zero padding
        # adds neither.
        pad_e = (ks, ks + pad[1], ks, ks + pad[3])
        kern = (th + 2 * ks, tw + 2 * ks)
        has = [F.max_pool2d(F.pad(m.float(), pad_e)[None, None], kern, (th, tw))[0, 0] > 0
               for m in (vert_b, ~vert_b)]
        bands = has[0].int() + has[1].int()
        out["tiles_one_band"] = int(((bands == 1) & base_any).sum())
        out["tiles_two_bands"] = int(((bands == 2) & base_any).sum())
        out["tiles"] = bands.numel()
    return out


def mixed_axes(fields: dict, kind: str, block: int = 64) -> dict:
    """The fields with the per-pixel axis set per pixel: vertical on a
    checkerboard of `block`-pixel squares, or below the diagonal from the
    top-left corner to the bottom-right one."""
    import torch

    h, w = fields["avg1"].shape
    yy, xx = np.mgrid[0:h, 0:w]
    vert = (yy // block + xx // block) % 2 if kind == "checker" else xx * h > yy * w
    return dict(fields, vert=torch.as_tensor(vert.astype(np.float32),
                                             device=fields["avg1"].device))


def check_sweep(fields: dict, axis, kw: dict, reps: int, label: str = "") -> dict:
    """K1 against its plain version on the same fields: the per-pixel form
    bit for bit, the static forms within K1's tolerances; reps > 0 also
    times both and states the bound. The per-pixel form prints its tile
    votes and the tiles that stage one band of w0 or two."""
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
            and pos_eq > SWEEP_POS_EQ_MIN) or (axis is None and not exact):
        raise AssertionError(
            f"K1 {name}: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}, bit-equal {exact}"
        )
    votes = ""
    if reps or axis is None:
        ev = sweep_evaluations(
            fields, axis, kw["corridor_size"], kw["window"], kw["h2"], kw["w2"],
            kw["min_stdev"],
        )
        th, tw = k1.TILES[axis]
        votes = (f"; evaluated hypotheses {ev['n_eval']}, tile votes passed"
                 f" {ev['tile_votes']}, i.e. {ev['tile_votes'] * th * tw}"
                 f" pixel-hypotheses computed"
                 f" ({ev['tile_votes'] * th * tw / max(ev['n_eval'], 1):.2f}x the evaluated ones)")
        if axis is None:
            votes += (f"; tiles staging one band {ev['tiles_one_band']}, two bands"
                      f" {ev['tiles_two_bands']}, of {ev['tiles']}")
    if not reps:
        print(f"K1 {name} at {h}x{w}, window {kw['window']}: valid"
              f" {valid_share:.4f}, flips {flip:.6f}, max|dcorr| {err:.3g},"
              f" positions equal {pos_eq:.6f}, bit-equal {exact}{votes}")
        return {"err": err, "exact": exact, "valid_share": valid_share}
    ms = cuda_ms(lambda: k1.ncc_sweep(*args, axis=axis, **kw), reps)
    plain_ms = cuda_ms(lambda: k1.ncc_sweep_plain(*args, axis=axis, **kw), 1)
    n_o = fields["w0"].shape[0]
    # Inputs read once (the vert plane only by the per-pixel form), three
    # outputs written once.
    n_planes = 9 + (axis is None) + n_o + 3
    n_bytes = 4.0 * h * w * n_planes
    n_ops = SWEEP_OPS_PER_EVAL * ev["n_eval"] + 41.0 * n_o * h * w
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"K1 {name}: valid {valid_share:.4f}, flips {flip:.6f},"
        f" max|dcorr| {err:.3g}, positions equal {pos_eq:.6f}, bit-equal"
        f" {exact}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}){votes}"
    )
    return {"err": err, "exact": exact, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "valid_share": valid_share,
            "n_eval": ev["n_eval"], "fields": fields, "axis": axis}


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
            out["per-pixel"] = check_sweep(mixed_axes(fields, "checker"), None, kw, reps=3)
    return out


def phase_sweep_wide(device, mesh) -> list[dict]:
    """K1's three forms at 1024x1024 and window 192, which sweep each
    stripe's offsets in chunks (the per-pixel form on phase 2's
    checkerboard of axes): bit-equal to the plain version and timed;
    then the row-halo form (K1s) at 192 over the mesh, bit-equal to its
    plain version and to the unsharded kernel."""
    from cybervision_tpu_torch.ops import ncc_sweep as k1

    res = []
    for axis in ("horiz", "vert", None):
        fields, kw = sweep_case(device, axis or "horiz", SIZE, SIZE, WIDE_WINDOW)
        if axis is None:
            fields = mixed_axes(fields, "checker")
        chunks = k1.sweep_tile_plan(SIZE, SIZE, WIDE_WINDOW, axis)["chunks"]
        r = check_sweep(fields, axis, kw, reps=3, label=f" at window {WIDE_WINDOW}")
        print(f"K1 {axis or 'per-pixel'} at window {WIDE_WINDOW}: chunks {chunks}")
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
    """K1's three forms off the tile grid (999x777) and at the window
    buckets' ends (8 and 128, on a 300x280 plane), the per-pixel form with
    its axis flipping across the diagonal: checked, not timed."""
    res = []
    for axis in ("horiz", "vert", None):
        for h, w, window in ((999, 777, None), (300, 280, 8), (300, 280, 128)):
            fields, kw = sweep_case(device, axis or "horiz", h, w, window)
            if axis is None:
                fields = mixed_axes(fields, "diagonal")
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
    dev_ms = {name: device_ms_by_kernel(prof)[1][name] for name in counters}
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
            and pos_eq > SWEEP_POS_EQ_MIN) or (axis is None and not exact):
        raise AssertionError(
            f"K1s {name} vs plain: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}, bit-equal {exact}"
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


def check_sharded_plan(label: str, plan: dict, shape1, shape2, mesh) -> None:
    """A correlate_images plan under `mesh`: every level whose rows shard
    (correlation.prologue_shardable, both images) ran row-sharded from
    resize to cross-check, the others on the lead; some refine level's
    sweeps ran as K1s."""
    from cybervision_tpu_torch.config import CorrelationConfig, pyramid_scales
    from cybervision_tpu_torch.ops import correlation

    scales = pyramid_scales(shape1[::-1], CorrelationConfig().scale_min_size)
    want = [all(correlation.prologue_shardable(correlation.resized_shape(sh, s)[0], mesh.size)
                for sh in (shape1, shape2)) for s in scales]
    if not (plan["mesh"] and plan["sharded_prologue"] == want and any(plan["sharded_levels"])):
        raise AssertionError(f"{label}: plan {plan}, want sharded levels {want}")


def phase_same_correlation(img1, img2, matches, mesh, device) -> None:
    """correlate_images under the mesh for the F of an unsharded RANSAC
    run: its delta and word planes equal the unsharded run's, and every
    level deep enough ran row-sharded."""
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
    if not same:
        raise AssertionError("the sharded correlation differs from the unsharded one")
    check_sharded_plan("correlate_images under the mesh", plan, img1.shape, img2.shape, mesh)


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


def reconstruct_runs(images, cfg, out: str, counters, warm: int):
    """One cold (or warm-up) run of reconstruct on the in-memory images,
    then `warm` timed runs, each with the kernels' launch counts set to
    0 just before and read just after; every card synchronised before a
    clock stops. Returns (first run's seconds, [(seconds, phases,
    launches)])."""
    import torch

    from cybervision_tpu_torch.reconstruction import reconstruct

    names = ["synth_a.png", "synth_b.png"]

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    t0 = time.perf_counter()
    reconstruct(names, out, cfg, quiet=True, images=images)
    sync()
    first_s = time.perf_counter() - t0
    runs = []
    for _ in range(warm):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        phases = reconstruct(names, out, cfg, quiet=True, images=images)
        sync()
        dt = time.perf_counter() - t0
        runs.append((dt, phases, {name: getattr(mod, attr)
                                  for name, (mod, attr) in counters.items()}))
    return first_s, runs


def report_runs(label: str, first: str, first_s: float, runs) -> tuple:
    """Print the runs' seconds, the best run's phases and the launches per
    run; fail when a kernel was not launched or the counts vary.
    Returns the best run (seconds, phases, launches)."""
    best = min(runs, key=lambda r: r[0])
    if any(r[2] != runs[0][2] for r in runs):
        raise AssertionError(f"{label}: launch counts vary between runs: {[r[2] for r in runs]}")
    print(f"{label}: {first} {first_s:.3f} s, warm best of {len(runs)} {best[0]:.3f} s"
          f" (runs {[round(r[0], 4) for r in runs]})")
    print(f"{label}: phases of the best run " + json.dumps(
        {k: round(v, 4) for k, v in best[1].items()}))
    print(f"{label}: launches per run {best[2]}")
    for name, n in best[2].items():
        if n == 0:
            raise AssertionError(f"{label}: the path never launched {name}")
    return best


def phase_end_to_end(img1, img2, disparity, counters, mesh=None,
                     label="end to end") -> dict:
    """The main path through reconstruct, under `mesh` (None: the
    single-card path): one warm-up run, then three timed runs.
    counters: kernel name -> (module, attribute) of its launch count."""
    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.parallel import use_mesh

    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    # In memory, the colour plane is the gray one repeated: PIL's
    # convert("RGB") of an "L" image.
    images = [SourceImage(im) for im in (img1, img2)]
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, "mesh.ply")
        cold_s, runs = reconstruct_runs(images, cfg, out, counters, 3)
        xyz = read_ply_vertices(out)
    plan = dict(correlation._LAST_PLAN)
    best_s, phases, launches = report_runs(label, "cold", cold_s, runs)
    print(f"{label}: correlation plan {plan}")

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
    return {"seconds": best_s, "launches": launches, "plan": plan, "phases": phases,
            "xyz": xyz}


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every device event of a profiled
    window, read from the raw kineto results: prof.events() first builds
    the whole host/device event tree, tens of seconds for the ~10^5
    events of a perspective run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [
        (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        for e in prof.profiler.kineto_results.events() if e.device_type() == cuda
    ]


def device_ms_by_kernel(prof) -> tuple[dict[str, float], dict[str, float]]:
    """Device milliseconds of a profiled window per kernel name, and per
    wrapper (KERNEL_NAMES), summed over the raw device events
    (key_averages over ~10^5 events costs tens of seconds)."""
    durs: dict[str, float] = {}
    for name, start, end in device_events(prof):
        durs[name] = durs.get(name, 0.0) + (end - start) / 1e3
    per_wrapper = {name: sum(v for k, v in durs.items() if any(n in k for n in keys))
                   for name, keys in KERNEL_NAMES.items()}
    return durs, per_wrapper


def device_busy_us(prof) -> tuple[float, int]:
    """Microseconds in which the card ran at least one kernel during a
    profiled window (the union of its device events), and their count."""
    spans = sorted((s, e) for _, s, e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, len(spans)


def profile_end_to_end(img1, img2, mesh=None, label="profile", cfg=None,
                       out_name="mesh.ply") -> dict:
    """One warm run of reconstruct under torch.profiler (under `mesh`;
    None: the single-card path), of `cfg` (default: the main path's PLY
    config) to `out_name`: the card's busy share of the run (union of
    device-event intervals over the host wall time), the kernels by
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

    cfg = cfg or ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    images = [SourceImage(im) for im in (img1, img2)]
    names = ["synth_a.png", "synth_b.png"]
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, out_name)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reconstruct(names, out, cfg, quiet=True, images=images)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_events = device_busy_us(prof)
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms"
          f" ({busy / wall_us:.4f} of the run), {n_events} device events")
    durs, per_kernel = device_ms_by_kernel(prof)
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:15]
    print(f"{label}: device time by kernel (top 15, ms):"
          f" {json.dumps({k[:100]: round(v, 3) for k, v in top})}")
    print(f"{label}: device ms per run by wrapper {json.dumps(per_kernel)}")
    return per_kernel


# ---------------------------------------------------------------------------
# Phase 5: the affine lanes (BASELINE #1 and #4)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit RGB or RGBA PNG whose rows all
    use filter type 0, as the port's encoder writes them — with the
    standard library's zlib, no Pillow. Checks every chunk's CRC."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color_type = head[:4]
    if depth != 8 or color_type not in (2, 6):
        raise AssertionError(f"{path}: bit depth {depth}, colour type {color_type}")
    c = 4 if color_type == 6 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, c)


def phase_depth_map(img1, img2, disparity, ply_xyz, counters) -> dict:
    """BASELINE #1: the 1024x1024 pair to a PNG depth map with
    interpolation none, through reconstruct: a cold run, best of 3 warm
    runs, one profiled run. Gates on the PNG: over 30 % of the pixels
    opaque; the opaque pixels are exactly the vertices of phase 3's PLY
    (the same correlation), whose bounding box gives the crop offset; the
    depth read back through the nearest colour-table entry tracks the
    planted disparity, |r| >= 0.9."""
    from scipy.spatial import cKDTree

    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.output.colormap import _viridis_lut

    label = f"BASELINE #1 ({SIZE}x{SIZE} -> PNG depth map)"
    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE
    )
    images = [SourceImage(im) for im in (img1, img2)]
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "depth.png")
        cold_s, runs = reconstruct_runs(images, cfg, out, counters, 3)
        png_bytes = os.path.getsize(out)
        rgba = read_png(out)
    best_s, phases, launches = report_runs(label, "cold", cold_s, runs)
    device_ms = profile_end_to_end(img1, img2, label=f"profile of {label}", cfg=cfg,
                                   out_name="depth.png")

    opaque = rgba[:, :, 3] == 255
    share = float(opaque.sum()) / (SIZE * SIZE)
    vx = np.round(ply_xyz[:, 0]).astype(int)
    vy = np.round(-ply_xyz[:, 1]).astype(int)
    x0, y0 = int(vx.min()), int(vy.min())
    mask = np.zeros_like(opaque)
    if vx.max() - x0 < opaque.shape[1] and vy.max() - y0 < opaque.shape[0]:
        mask[vy - y0, vx - x0] = True
    same_pixels = bool(np.array_equal(mask, opaque))
    ys, xs = np.nonzero(opaque)
    k = cKDTree(_viridis_lut()).query(rgba[ys, xs, :3].astype(np.float64))[1]
    r = float(np.corrcoef(k, disparity[ys + y0, xs + x0])[0, 1])
    print(f"{label}: PNG {rgba.shape[1]}x{rgba.shape[0]} ({png_bytes} bytes) at offset"
          f" ({x0}, {y0}), {opaque.sum()} opaque pixels ({share:.4f} of the pair's),"
          f" equal to phase 3's PLY vertices {same_pixels}; colour-table index vs"
          f" planted disparity r {r:.4f}")
    if share <= 0.3:
        raise AssertionError(f"{label}: only {share:.3f} of the pixels are opaque")
    if not same_pixels:
        raise AssertionError(f"{label}: the opaque pixels are not the PLY's vertices")
    if abs(r) < 0.9:
        raise AssertionError(f"{label}: depth does not track the disparity (r {r:.3f})")
    return {"seconds": best_s, "launches": launches, "phases": phases,
            "device_ms": device_ms}


def read_obj(path: str):
    """(vertices (N, 3), vt count, face count) of an OBJ file."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    verts = [ln[2:] for ln in lines if ln.startswith(b"v ")]
    n_vt = sum(1 for ln in lines if ln.startswith(b"vt "))
    n_f = sum(1 for ln in lines if ln.startswith(b"f "))
    xyz = np.array(b" ".join(verts).split(), dtype=np.float64).reshape(-1, 3)
    return xyz, n_vt, n_f


def phase_texture_obj(device, counters, gen) -> dict:
    """BASELINE #4: a 4032x3024 pair to a texture-coordinates OBJ with
    --max-points 500,000, through reconstruct. One warm-up run; then K1
    in both static forms at the full-resolution level's window on this
    pair's fields (bit-equal to the plain version), and K2 and K3 at the
    pair's match table, each timed; then best of 2 timed runs and one
    profiled run. Gates: the vertex count is min(500,000, valid pixels)
    of the dense result for the same F (one more correlate_images run),
    each vertex sits at a valid pixel with that result's exact depth,
    there are faces and one vt per track and image, both texture PNGs
    equal the images, and the depth tracks the planted disparity."""
    import torch

    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    label = f"BASELINE #4 ({LARGE_W}x{LARGE_H} -> texture OBJ, --max-points {MAX_POINTS})"
    t0 = time.perf_counter()
    img1, img2, disparity = synth_sem_pair(LARGE_H, LARGE_W)
    print(f"{label}: pair made in {time.perf_counter() - t0:.1f} s")
    aff = ProjectionMode.AFFINE
    cfg = ReconstructionConfig(
        projection=aff, mesh=MeshMode.TEXTURE_COORDINATES, max_points=MAX_POINTS
    )
    images = [SourceImage(im) for im in (img1, img2)]
    res = {}
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "mesh.obj")
        warm_s, _ = reconstruct_runs(images, cfg, out, counters, 0)
        plan = dict(correlation._LAST_PLAN)
        window = max(plan["windows"][-1])
        print(f"{label}: warm-up {warm_s:.3f} s, correlation plan {plan}")

        t0 = time.perf_counter()
        for axis in ("horiz", "vert"):
            fields, kw = sweep_case(device, axis, LARGE_H, LARGE_W, window)
            r = check_sweep(fields, axis, kw, reps=3, label=f" at {LARGE_W}x{LARGE_H}")
            if not r["exact"]:
                raise AssertionError(f"K1 {axis} at {LARGE_W}x{LARGE_H}: not bit-equal to the plain version")
            res[f"K1 {axis}"] = {k: v for k, v in r.items() if k != "fields"}
            del fields, r
        torch.cuda.empty_cache()
        matches = main_path_matches(img1, img2, device)
        m = pow2_bucket(len(matches), floor=2048, factor=4)
        print(f"{label}: {len(matches)} matches, RANSAC table M = {m}")
        res["K2"] = check_score(matches, m, device, gen)
        res["K3"] = check_gather(matches, m, device, gen)
        print(f"{label}: kernel checks took {time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        _, runs = reconstruct_runs(images, cfg, out, counters, 2)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        xyz, n_vt, n_f = read_obj(out)
        tex = [read_png(os.path.join(td, f"mesh-{i}.png")) for i in range(2)]
    best_s, phases, launches = report_runs(label, "warm-up", warm_s, runs)
    print(f"{label}: peak device memory of the timed runs {peak_gib:.3f} GiB")
    device_ms = profile_end_to_end(img1, img2, label=f"profile of {label}", cfg=cfg,
                                   out_name="mesh.obj")
    draws = phase_word_sample(device)

    f = find_fundamental_matrix(matches, aff, float(LARGE_W), device=device, mesh=None).f
    word = correlation.correlate_images(
        *images, f, aff, cfg.correlation, device_out="word", device=device, mesh=None,
    ).cpu().numpy()
    valid = ((word >> 24) & 1) == 1
    n_valid = int(valid.sum())
    xs = np.round(xyz[:, 0]).astype(int)
    ys = np.round(-xyz[:, 1]).astype(int)
    at = word[ys, xs]
    exact = -np.hypot(xs - (at & 0xFFF), ys - ((at >> 12) & 0xFFF))
    on_valid = bool(valid[ys, xs].all())
    same_depth = bool(np.array_equal(xyz[:, 2], exact))
    distinct = len(np.unique(ys.astype(np.int64) * LARGE_W + xs)) == len(xyz)
    r = float(np.corrcoef(-xyz[:, 2], disparity[ys, xs])[0, 1])
    tex_ok = [t.shape == (LARGE_H, LARGE_W, 3) and np.array_equal(t, np.repeat(im[:, :, None], 3, 2))
              for t, im in zip(tex, (img1, img2))]
    print(f"{label}: OBJ {len(xyz)} vertices of {n_valid} valid pixels ({n_valid / (LARGE_H * LARGE_W):.4f}"
          f" of the pair), {n_vt} vt, {n_f} faces; vertices at distinct valid pixels"
          f" {on_valid and distinct}, depths equal to the dense result {same_depth};"
          f" depth vs planted disparity r {r:.4f}; textures equal to the images {tex_ok}")
    if len(xyz) != min(MAX_POINTS, n_valid) or not (on_valid and distinct and same_depth):
        raise AssertionError(f"{label}: the vertices are not a --max-points draw of the valid pixels")
    if n_f == 0 or n_vt != 2 * len(xyz):
        raise AssertionError(f"{label}: {n_f} faces, {n_vt} texture coordinates")
    if not all(tex_ok):
        raise AssertionError(f"{label}: a texture differs from its image")
    if r < 0.9:
        raise AssertionError(f"{label}: depth does not track the disparity (r {r:.3f})")
    return {"seconds": best_s, "launches": launches, "phases": phases,
            "device_ms": device_ms, "kernels": res, "m": m, "draws": draws,
            "peak_gib": peak_gib}


def phase_word_sample(device) -> dict:
    """The --max-points draw of BASELINE #4 on the card, by its parts:
    utils.prng.uniform over the 12.2 M pixels (float64, JAX's threefry)
    and the stable sort of the scores (CUDA events around 5 calls each,
    after a warm-up), and sample_word_grid whole on a word grid with 90 %
    of its pixels valid; the card's draw equals the CPU's."""
    import torch

    from cybervision_tpu_torch.ops.correlation import sample_word_grid
    from cybervision_tpu_torch.utils import prng

    n = LARGE_H * LARGE_W
    key = prng.prng_key(0)
    u = prng.uniform(key, (n,), device)
    # The draw of a flat index depends on the key and the index alone, so
    # a prefix is the draw of a shorter shape.
    m = min(n, 1 << 20)
    same = torch.equal(u[:m].cpu(), prng.uniform(key, (m,)))
    uniform_ms = cuda_ms(lambda: prng.uniform(key, (n,), device), 5)
    sort_ms = cuda_ms(lambda: torch.sort(-u, stable=True), 5)
    g = torch.Generator(device=device)
    g.manual_seed(1)
    word = torch.where(torch.rand((LARGE_H, LARGE_W), generator=g, device=device) < 0.9,
                       1 << 24, 0).to(torch.int32)
    sample_ms = cuda_ms(lambda: sample_word_grid(word, MAX_POINTS, 0), 5)
    print(f"--max-points draw over {n} pixels: uniform (float64 threefry) {uniform_ms:.3f} ms,"
          f" stable sort {sort_ms:.3f} ms, sample_word_grid whole {sample_ms:.3f} ms"
          f" (CUDA events, 5 calls); card's uniform equals the CPU's on the first {m}: {same}")
    if not same:
        raise AssertionError("the card's uniform draw differs from the CPU's")
    return {"uniform_ms": uniform_ms, "sort_ms": sort_ms, "sample_ms": sample_ms}


# ---------------------------------------------------------------------------
# Phase 6: the perspective path (BASELINE #3 and #5, and the full width)


def render_perspective(w: int, h: int, extra, seed: int = 3, exact_focal: bool = False):
    """tests/perspective_scene.render_views at w x h, K scaled with the
    image (400 px of focal length at 320x256): a texture on one world
    depth surface depth1(u, v) over camera 1's grid (camera 1 = identity
    pose), each extra view rendered by per-pixel fixed-point inversion of
    its rays onto that surface. `extra` holds the extra cameras as
    (axis-angle rotation, translation) pairs; with exact_focal the focal
    length is the one PERSP_FOCAL_35MM gives (407.3 px at 320x256, not
    400). Returns (views, depth1, k, cameras)."""
    from cybervision_tpu_torch.ops.surface import Camera

    f = PERSP_F * w / PERSP_W
    if exact_focal:
        f = PERSP_FOCAL_35MM * np.hypot(w, h) / np.hypot(24.0, 36.0)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cams = [Camera(k=k, r=np.array(r), t=np.array(t)) for r, t in extra]
    rng = np.random.RandomState(seed)
    tex = rng.uniform(0, 255, (h, w))
    tex = ndimage.gaussian_filter(tex, 1.0)
    bumps = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 6.0)
    img1 = tex * 0.55 + bumps * 0.45
    img1 = (img1 - img1.min()) / (img1.max() - img1.min()) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    depth1 = (
        8.0
        + 3.5 * np.sin(xs / w * 5.0)
        + 2.5 * (ys / h) ** 2
        + 1.5 * np.cos(ys / h * 7.0 + xs / w * 2.0)
    )
    k_inv = np.linalg.inv(k)

    def sample_depth1(u, v):
        return ndimage.map_coordinates(depth1, [v, u], order=1, mode="nearest")

    views = [np.round(img1).astype(np.uint8)]
    h_grid = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    for cam in cams:
        rays_c = h_grid @ k_inv.T
        r = cam.r_matrix
        d = np.full((h, w), float(depth1.mean()))
        for _ in range(12):
            pts_w = (rays_c * d[:, :, None] - cam.t[None, None, :]) @ r
            z1 = np.maximum(pts_w[:, :, 2], 1e-6)
            u1 = k[0, 0] * pts_w[:, :, 0] / z1 + k[0, 2]
            v1 = k[1, 1] * pts_w[:, :, 1] / z1 + k[1, 2]
            d = d * np.clip(sample_depth1(u1, v1) / z1, 0.5, 2.0)
        img_k = ndimage.map_coordinates(img1, [v1, u1], order=3, mode="nearest")
        views.append(np.round(np.clip(img_k, 0, 255)).astype(np.uint8))
    return views, depth1, k, cams


def _angle_deg(cos):
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def perspective_gates(label: str, rec, true_cams, depth1, out: str,
                      min_vertices: int, min_faces: int | None, pose_tol) -> dict:
    """The run's geometry against the renderer: every view recovered; each
    extra camera's rotation and translation direction within its
    pose_tol entry (degrees) of the renderer's after aligning camera 1 (the
    reconstruction's frame and scale are free); every point in front of
    the cameras that see it; depth seen from camera 1 tracking depth1 at
    the projected pixels (Pearson r >= DEPTH_R_MIN); the file's vertex
    (and face) counts above the JAX package's test floors."""
    surface = rec.surface
    cams = surface.cameras
    if len(cams) != len(true_cams) + 1:
        raise AssertionError(f"{label}: {len(cams)} cameras recovered of {len(true_cams) + 1}")
    r0, t0 = cams[0].r_matrix, cams[0].t
    rot_err, dir_err = [], []
    for cam, true in zip(cams[1:], true_cams):
        r_rel = cam.r_matrix @ r0.T
        t_rel = cam.t - r_rel @ t0
        rot_err.append(_angle_deg((np.trace(r_rel @ true.r_matrix.T) - 1.0) / 2.0))
        dir_err.append(_angle_deg(t_rel @ true.t / (np.linalg.norm(t_rel) * np.linalg.norm(true.t))))
    pts = surface.points3d
    behind = sum(int((~cam.point_in_front(pts[surface.track_visible(i)])).sum())
                 for i, cam in enumerate(cams))
    h, w = depth1.shape
    uv = surface.project_points(0)
    z = pts @ r0[2] + t0[2]
    inside = np.all(np.isfinite(uv), axis=1) & (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) \
        & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1)
    truth = depth1[np.round(uv[inside, 1]).astype(int), np.round(uv[inside, 0]).astype(int)]
    r_depth = float(np.corrcoef(z[inside], truth)[0, 1])
    n_v, n_f = read_mesh_counts(out)
    print(f"{label}: cameras rotation err {[round(x, 4) for x in rot_err]} deg, translation"
          f" direction err {[round(x, 4) for x in dir_err]} deg; {len(pts)} points,"
          f" {behind} behind a camera that sees them; depth vs the renderer r {r_depth:.4f}"
          f" ({int(inside.sum())} points in camera 1's image); file: {n_v} vertices, {n_f} faces")
    if any(r > tol[0] or d > tol[1] for r, d, tol in zip(rot_err, dir_err, pose_tol)):
        raise AssertionError(f"{label}: camera poses off the renderer's beyond {pose_tol} deg")
    if behind:
        raise AssertionError(f"{label}: {behind} points behind a camera that sees them")
    if not (r_depth >= DEPTH_R_MIN):
        raise AssertionError(f"{label}: depth does not track the renderer's (r {r_depth:.3f})")
    if n_v <= min_vertices or (min_faces is not None and n_f <= min_faces):
        raise AssertionError(f"{label}: {n_v} vertices / {n_f} faces, floors {min_vertices} / {min_faces}")
    return {"rot_err_deg": rot_err, "dir_err_deg": dir_err,
            "depth_r": r_depth, "vertices": n_v, "faces": n_f}


def read_mesh_counts(path: str) -> tuple[int, int]:
    """(vertices, faces) of a PLY (header counts) or an OBJ (v / f lines)."""
    if path.endswith(".ply"):
        with open(path, "rb") as fh:
            head = fh.read(4096).partition(b"end_header\n")[0].decode()
        n_v = int(head.split("element vertex ")[1].split("\n")[0])
        n_f = int(head.split("element face ")[1].split("\n")[0])
        return n_v, n_f
    n_v = n_f = 0
    with open(path) as fh:
        for line in fh:
            n_v += line.startswith("v ")
            n_f += line.startswith("f ")
    return n_v, n_f


def _group_phases(phases: dict) -> dict:
    """A run's phase seconds in the perspective path's groups."""
    def s(*keys):
        return round(sum(v for k, v in phases.items() if any(k.startswith(p) for p in keys)), 4)

    return {
        "matching": s("Extracted feature points", "Matched keypoints"),
        "ransac": s("Completed RANSAC fitting"),
        "pose_recovery": s("Recovered camera poses"),
        "dense": s("Completed dense correlation", "Fetched correlation grid", "Added dense image pair"),
        "track_merge": s("Merged tracks for"),
        "dlt": s("Finalize DLT"),
        "outlier_filter": s("Finalize outlier filter"),
        "bundle_adjustment": s("Finalize bundle adjustment"),
        "save": s("Saved result"),
        "total": s("Completed reconstruction"),
    }


class _Capture:
    """Records, during one run, the per-pair RANSAC inputs and results,
    the inputs of the largest K1 call (cloned: the finest level's) and
    the smallest
    and largest DLT triangulation's inputs, passing every call through."""

    def __init__(self):
        from cybervision_tpu_torch.ops import correlation, epipolar, sfm

        self.mods = (correlation, epipolar, sfm)
        self.pairs = None
        self.results = None
        self.sweep = None
        self.dlt = []

    def __enter__(self):
        correlation, epipolar, sfm = self.mods
        self.orig = (correlation.ncc_sweep, epipolar.find_fundamental_matrix_multi,
                     sfm.triangulate_tracks_np)
        sweep, multi, dlt = self.orig

        def sweep_rec(*args, **kw):
            if self.sweep is None or args[5].numel() > self.sweep[0][5].numel():
                self.sweep = ([a.clone() for a in args], dict(kw))
            return sweep(*args, **kw)

        def multi_rec(matches_list, projection, max_dims, *a, **kw):
            self.pairs = (list(matches_list), list(max_dims))
            self.results = multi(matches_list, projection, max_dims, *a, **kw)
            return self.results

        def dlt_rec(pts, projections, *a, **kw):
            self.dlt.append((pts.copy(), list(projections)))
            self.dlt = [min(self.dlt, key=lambda c: len(c[0])),
                        max(self.dlt, key=lambda c: len(c[0]))]
            return dlt(pts, projections, *a, **kw)

        correlation.ncc_sweep = sweep_rec
        epipolar.find_fundamental_matrix_multi = multi_rec
        sfm.triangulate_tracks_np = dlt_rec
        return self

    def __exit__(self, *exc):
        correlation, epipolar, sfm = self.mods
        (correlation.ncc_sweep, epipolar.find_fundamental_matrix_multi,
         sfm.triangulate_tracks_np) = self.orig
        return False


def perspective_runs(label: str, views, cfg, out: str, counters, warm: int,
                     exif: bool):
    """One warm-up run, `warm` timed runs (launch counts set to 0 just
    before each, read just after; peak device memory over them), and one
    profiled run (the card's busy share, each wrapper's device ms). The
    images ride in memory; with `exif` their 35 mm focal length is set
    as the EXIF tag would (the card's machine has no Pillow)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import Reconstruction

    images = [SourceImage(v, focal_length_35mm=PERSP_FOCAL_35MM if exif else None)
              for v in views]
    names = [f"view{i}.png" for i in range(len(views))]

    def one():
        rec = Reconstruction(names, out, cfg, quiet=True, images=images)
        rec.run()
        torch.cuda.synchronize()
        return rec

    cap = _Capture()
    t0 = time.perf_counter()
    with cap:
        one()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(warm):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        rec = one()
        dt = time.perf_counter() - t0
        runs.append((dt, rec, {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_prof = time.perf_counter()
    busy, n_events = device_busy_us(prof)
    durs, dev_ms = device_ms_by_kernel(prof)
    dev_ms["ncc_sweep_pixel"] = sum(v for k, v in durs.items() if "sweep_pixel_tile_kernel" in k)
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: device time by kernel (top 8, ms):"
          f" {json.dumps({k[:100]: round(v, 3) for k, v in top})};"
          f" profile read in {time.perf_counter() - t_prof:.1f} s")
    best_s, rec, launches = min(runs, key=lambda r: r[0])
    if any(r[2] != runs[0][2] for r in runs):
        raise AssertionError(f"{label}: launch counts vary between runs: {[r[2] for r in runs]}")
    print(f"{label}: warm-up {warmup_s:.3f} s, warm best of {warm} {best_s:.4f} s"
          f" (runs {[round(r[0], 4) for r in runs]}); peak device memory {peak_gib:.3f} GiB")
    print(f"{label}: phases of the best run {json.dumps(_group_phases(rec.phases))}")
    print(f"{label}: launches per run {launches} (K1 per-pixel form"
          f" {launches['ncc_sweep_pixel']}, static forms"
          f" {launches['ncc_sweep'] - launches['ncc_sweep_pixel']})")
    print(f"{label}: profiled run wall {wall_us / 1e3:.3f} ms, device busy"
          f" {busy / 1e3:.3f} ms ({busy / wall_us:.4f} of the run), {n_events} device"
          f" events; device ms by wrapper {json.dumps({k: round(v, 4) for k, v in dev_ms.items()})}")
    print(f"{label}: ransac_failures {rec.ransac_failures}, dense_failures {rec.dense_failures}")
    return {"seconds": best_s, "rec": rec, "launches": launches, "peak_gib": peak_gib,
            "busy_share": busy / wall_us, "device_ms": dev_ms,
            "phases": _group_phases(rec.phases), "capture": cap}


def check_pair_failures(label: str, rec, n_views: int) -> None:
    """No pair fails, but for the 3-view scene's pair (views 2 and 3):
    the JAX package proves it unlinkable at the default acceptance floor
    (tests/test_pipeline_perspective.py::
    test_bench_dropped_pair_is_provably_unlinkable: the true F admits
    fewer than 200 of its matches), so its RANSAC may fail there; no
    dense correlation may fail."""
    allowed = 1 if n_views == 3 else 0
    if rec.ransac_failures > allowed or rec.dense_failures:
        raise AssertionError(
            f"{label}: {rec.ransac_failures} RANSAC / {rec.dense_failures} dense"
            f" failures (at most {allowed} / 0)")


def check_score_perspective(matches, max_dim: float, device, gen, reps=5) -> dict:
    """K2 at the perspective path's shape: 50,000 7-point samples of the
    pair's table solved as the main path solves them (Hartley in, up to
    three roots, F_px = T2^T F' T1), C = 150,000 candidates against the
    pair's bucketed table; counts equal, sums within rtol 1e-5."""
    import torch

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops import score as k2
    from cybervision_tpu_torch.ops.epipolar import _hartley_np, solve_perspective_batch
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    rc = RansacConfig()
    t = rc.params(ProjectionMode.PERSPECTIVE)[2] * max_dim
    m_bucket = pow2_bucket(len(matches), floor=2048, factor=4)
    p1, p2, m_valid, _, top_limit = ransac_tables(matches, m_bucket, device)
    t1 = torch.as_tensor(_hartley_np(matches[:, 0:2]), dtype=torch.float32, device=device)
    t2 = torch.as_tensor(_hartley_np(matches[:, 2:4]), dtype=torch.float32, device=device)
    idx = torch.randint(0, top_limit, (BATCH, 7), generator=gen, device=device)
    n1 = torch.einsum("ij,bnj->bni", t1[:2, :2], p1[idx]) + t1[:2, 2]
    n2 = torch.einsum("ij,bnj->bni", t2[:2, :2], p2[idx]) + t2[:2, 2]
    f, valid = solve_perspective_batch(n1, n2, rc.rank_epsilon)
    f = torch.einsum("ji,brjk,kl->bril", t2, f, t1)
    f = f / torch.where(f[..., 2:, 2:].abs() > 1e-20, f[..., 2:, 2:], 1.0)
    ff = f.reshape(-1, 3, 3).contiguous()
    c = ff.shape[0]
    ck, sk = k2.score_candidates(ff, p1, p2, m_valid, t)
    cp, sp = k2.score_candidates_plain(ff, p1, p2, m_valid, t)
    torch.cuda.synchronize()
    label = f"K2 perspective C={c} M={m_bucket}"
    if not torch.equal(ck, cp):
        raise AssertionError(f"{label}: {int((ck != cp).sum())} counts differ")
    if not torch.allclose(sk, sp, rtol=SCORE_RTOL, atol=0.0):
        raise AssertionError(f"{label}: error sums beyond rtol {SCORE_RTOL}")
    err = float((sk - sp).abs().max())
    ms = cuda_ms(lambda: k2.score_candidates(ff, p1, p2, m_valid, t), reps)
    plain_ms = cuda_ms(lambda: k2.score_candidates_plain(ff, p1, p2, m_valid, t), 1)
    m_work = int(m_valid.sum())
    b_ms, b_by = bound_ms(c * 9 * 4 + m_bucket * (4 * 4 + 1) + c * 8, 36.0 * c * m_work)
    print(f"{label}: counts equal (max {int(ck.max())}, {int(valid.sum())} valid roots),"
          f" max|dsum| {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
          f" bound {b_ms:.4f} ms ({b_by}, {m_work} valid rows)")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_gather_shape(matches, device, gen, n_samples: int) -> dict:
    """K3 at (13, n_samples, 50,000) draws from the pair's packed table:
    exact against its plain version and index_select; CUDA events around
    200 calls each."""
    import torch

    from cybervision_tpu_torch.ops import gather as k3
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    m_bucket = pow2_bucket(len(matches), floor=2048, factor=4)
    _, _, _, packed, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(0, top_limit, (DRAW_ROUNDS, n_samples, BATCH), generator=gen,
                        device=device, dtype=torch.int32)
    flat = idx.reshape(-1)
    out_k = k3.gather_packed(packed, idx)
    out_p = k3.gather_packed_plain(packed, idx)
    out_l = torch.index_select(packed, 1, flat).reshape(out_p.shape)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_l, out_p)):
        raise AssertionError(f"K3 {tuple(idx.shape)}: gathers differ")
    ms = cuda_ms(lambda: k3.gather_packed(packed, idx), 200)
    lib_ms = cuda_ms(lambda: torch.index_select(packed, 1, flat), 200)
    plain_ms = cuda_ms(lambda: k3.gather_packed_plain(packed, idx), 20)
    k = idx.numel()
    b_ms, b_by = bound_ms(4.0 * k + 4.0 * packed.numel() + 8.0 * k, 0.0)
    print(f"K3 {tuple(idx.shape)} M={m_bucket}: exact; kernel {ms:.4f} ms, plain"
          f" {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_dlt_paths(label: str, calls, device, reps: int = 5) -> list[dict]:
    """The DLT's smallest-eigenvector solve on the run's smallest and
    largest triangulation inputs: the host float64 eigh (the JAX
    package's path below 32,768 tracks) against
    sfm_device.dlt_nullspaces (float32 eigh on the card + float64 host
    polish), each timed whole, numpy in and out (best of 2 x `reps`, host
    clock). The dehomogenised points (|w| > 1e-3) must agree within
    DLT_AGREE_REL of the point's norm; the share within 1e-9 is printed."""
    from cybervision_tpu_torch.ops import sfm, sfm_device

    out = []
    for pts, projections in calls:
        ata, n_views = sfm.dlt_normals(pts, projections)
        a = ata[n_views >= 2]

        def host():
            return np.linalg.eigh(a)[1][:, :, 0]

        def card():
            return sfm_device.dlt_nullspaces(a, device)

        times = {}
        for name, fn in (("host", host), ("card", card), ("host", host), ("card", card)):
            for _ in range(reps):
                t0 = time.perf_counter()
                h = fn()
                times[name] = min(times.get(name, np.inf), time.perf_counter() - t0)
        h_host, h_card = host(), card()
        ok = (np.abs(h_host[:, 3]) > 1e-3) & (np.abs(h_card[:, 3]) > 1e-3)
        p_host = h_host[ok, :3] / h_host[ok, 3:]
        p_card = h_card[ok, :3] / h_card[ok, 3:]
        rel = float(np.max(np.linalg.norm(p_card - p_host, axis=1)
                           / np.maximum(np.linalg.norm(p_host, axis=1), 1e-12), initial=0.0))
        frac = float(np.mean(np.linalg.norm(p_card - p_host, axis=1)
                             <= 1e-9 * np.linalg.norm(p_host, axis=1))) if ok.any() else 1.0
        print(f"{label}: DLT of {len(a)} tracks ({len(projections)} cameras): host eigh"
              f" {times['host'] * 1e3:.3f} ms, card eigh + host polish"
              f" {times['card'] * 1e3:.3f} ms (best of {2 * reps}); points agree within"
              f" 1e-9 for {frac:.6f} (max rel {rel:.3g})")
        if not rel <= DLT_AGREE_REL:
            raise AssertionError(f"{label}: the DLT's two solves differ by {rel:.3g} relative")
        out.append({"tracks": len(a), "host_ms": times["host"] * 1e3,
                    "card_ms": times["card"] * 1e3, "max_rel": rel, "frac_1e9": frac})
    return out


def phase_perspective(device, counters, gen) -> dict:
    """BASELINE #3 (2 views of 320x256 -> OBJ, the EXIF focal length,
    bundle adjustment, default RANSAC budgets), BASELINE #5 (3 views ->
    merged PLY, --focal-length 43), the same 3-view scene at 1024x820
    (K x3.2) -> merged PLY, and the diagonal pair at 1024x820 -> OBJ,
    whose epipolar lines cross the image's diagonal (K1's per-pixel form
    on the main path); then K1's per-pixel form at the diagonal run's
    finest level, K2 and K3
    at the 3-view full-width run's largest pair, against their plain
    versions."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )

    counters = dict(counters, ncc_sweep_pixel=(counters["ncc_sweep"][0], "pixel_launches"))
    persp = dict(projection=ProjectionMode.PERSPECTIVE,
                 interpolation=InterpolationMode.DELAUNAY, mesh=MeshMode.VERTEX_COLORS)
    b5_tol = [(r + POSE_MARGIN_DEG, d + POSE_MARGIN_DEG) for r, d in POSE_REF_BASELINE5]
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for key, label, extra, scale, ext, exif, warm, floors, pose_tol in (
            ("baseline3", "BASELINE #3 (2 views 320x256 -> OBJ)", PERSP_CAMS[:1], 1.0, "obj",
             True, 2, (2000, None), [POSE_TOL_DEG]),
            ("baseline5", "BASELINE #5 (3 views 320x256 -> merged PLY)", PERSP_CAMS, 1.0, "ply",
             False, 2, (2000, 1000), b5_tol),
            ("full_width", "full width (3 views 1024x820 -> merged PLY)", PERSP_CAMS, FULL_SCALE,
             "ply", False, 1, (2000, 1000), [POSE_TOL_DEG] * 2),
            ("diagonal", "full width diagonal (2 views 1024x820 -> OBJ, per-pixel axis)",
             (PERSP_CAM_DIAGONAL,), FULL_SCALE, "obj", False, 2, (2000, None), [POSE_TOL_DEG]),
        ):
            t0 = time.perf_counter()
            w, h = round(PERSP_W * scale), round(PERSP_H * scale)
            views, depth1, _, cams = render_perspective(w, h, extra)
            cfg = ReconstructionConfig(**persp, focal_length=None if exif else PERSP_FOCAL_35MM)
            path = os.path.join(td, f"persp_{key}.{ext}")
            r = perspective_runs(label, views, cfg, path, counters, warm, exif)
            check_pair_failures(label, r["rec"], len(views))
            r["gates"] = perspective_gates(label, r["rec"], cams, depth1, path, *floors, pose_tol)
            for name in ("ncc_sweep", "score_candidates", "gather_packed"):
                if r["launches"][name] == 0:
                    raise AssertionError(f"{label}: the path never launched {name}")
            if key == "diagonal" and r["launches"]["ncc_sweep_pixel"] == 0:
                raise AssertionError(f"{label}: K1's per-pixel form never launched")
            r["dlt"] = check_dlt_paths(label, r["capture"].dlt, device)
            r["scene"] = (views, depth1, cams)
            print(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
            out[key] = r
    args, kw = out["diagonal"]["capture"].sweep
    fields = dict(zip(("img1", "vert", "center", "coeff", "add", "avg1", "isd1",
                       "start", "end", "p_ok", "w0"), args))
    sweep_kw = {k: kw[k] for k in ("threshold", "min_stdev", "window", "corridor_size", "h2", "w2")}
    print(f"K1 at the diagonal run's finest level: the run took the"
          f" {kw['axis'] or 'per-pixel'} form, window {kw['window']}")
    k1_pixel = check_sweep(fields, None, sweep_kw, reps=3, label=" full-width diagonal perspective")
    matches_list, max_dims = out["full_width"]["capture"].pairs
    pi = int(np.argmax([len(m) for m in matches_list]))
    k2_persp = check_score_perspective(matches_list[pi], max_dims[pi], device, gen)
    k3_persp = check_gather_shape(matches_list[pi], device, gen, 7)
    return {"runs": out, "k1_pixel": k1_pixel, "k2": k2_persp, "k3": k3_persp}


def phase_mesh_perspective(mesh, device, counters, persp) -> dict:
    """Phase 7: the perspective path under phase 4's mesh, through
    reconstruction.Reconstruction: BASELINE #5 (3 views of 320x256 ->
    merged PLY), whose third view's pose comes from P3P candidates
    scored on every shard, and phase 6's diagonal pair at 1024x820
    (-> OBJ), whose refine levels run K1s's per-pixel form on every
    shard. Each: a warm-up run, best of 2 with launches per run, one
    profiled run (busy share, device ms by wrapper), phase 6's gates,
    and the correlation plan (every level deep enough row-sharded).
    Then correlate_images of the diagonal pair for the F of phase 6's
    unsharded run, under the mesh and without it: equal bit for bit."""
    import torch

    from cybervision_tpu_torch.config import (
        CorrelationConfig, InterpolationMode, MeshMode, ProjectionMode,
        ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation, ncc_sweep, sfm_device
    from cybervision_tpu_torch.parallel import use_mesh

    n = mesh.size
    counters = dict(
        counters, ncc_sweep_pixel=(ncc_sweep, "pixel_launches"),
        ncc_sweep_sharded=(ncc_sweep, "sharded_launches"),
        p3p_score=(sfm_device, "launches"), p3p_score_sharded=(sfm_device, "sharded_launches"),
    )
    persp_cfg = dict(projection=ProjectionMode.PERSPECTIVE,
                     interpolation=InterpolationMode.DELAUNAY, mesh=MeshMode.VERTEX_COLORS,
                     focal_length=PERSP_FOCAL_35MM)
    b5_tol = [(r + POSE_MARGIN_DEG, d + POSE_MARGIN_DEG) for r, d in POSE_REF_BASELINE5]
    out = {}
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        for key, label, ext, floors, pose_tol in (
            ("baseline5", f"BASELINE #5 under the mesh ({mesh.describe()})", "ply",
             (2000, 1000), b5_tol),
            ("diagonal", f"full width diagonal under the mesh ({mesh.describe()})", "obj",
             (2000, None), [POSE_TOL_DEG]),
        ):
            t0 = time.perf_counter()
            views, depth1, cams = persp["runs"][key]["scene"]
            path = os.path.join(td, f"mesh_{key}.{ext}")
            r = perspective_runs(label, views, ReconstructionConfig(**persp_cfg), path,
                                 counters, 2, False)
            plan = dict(correlation._LAST_PLAN)
            print(f"{label}: correlation plan of the last pair {plan}")
            check_pair_failures(label, r["rec"], len(views))
            r["gates"] = perspective_gates(label, r["rec"], cams, depth1, path, *floors, pose_tol)
            got = r["launches"]
            for name in ("ncc_sweep", "score_candidates", "gather_packed"):
                if got[name] == 0 or (name != "ncc_sweep" and got[name] % n):
                    raise AssertionError(f"{label}: {name} launched {got[name]} times over {n} shards")
            if key == "baseline5" and not got["p3p_score"] == n * got["p3p_score_sharded"] > 0:
                raise AssertionError(
                    f"{label}: P3P scored {got['p3p_score']} blocks in"
                    f" {got['p3p_score_sharded']} sharded calls over {n} shards")
            if key == "diagonal":
                if not (got["ncc_sweep_pixel"] == got["ncc_sweep"]
                        >= n * got["ncc_sweep_sharded"] > 0):
                    raise AssertionError(
                        f"{label}: K1s per-pixel launches {got['ncc_sweep_pixel']} of"
                        f" {got['ncc_sweep']}, {got['ncc_sweep_sharded']} sharded sweeps")
                check_sharded_plan(label, plan, views[0].shape, views[1].shape, mesh)
            r["plan"] = plan
            print(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
            out[key] = r

    views = persp["runs"]["diagonal"]["scene"][0]
    f = persp["runs"]["diagonal"]["capture"].results[0].f
    src = [SourceImage(v) for v in views]
    cc = CorrelationConfig()
    proj = ProjectionMode.PERSPECTIVE
    single = correlation.correlate_images(*src, f, proj, cc, device_out=True, device=device,
                                          mesh=None)
    sharded = correlation.correlate_images(*src, f, proj, cc, device_out=True, device=device,
                                           mesh=mesh)
    plan = correlation._LAST_PLAN
    torch.cuda.synchronize()
    same = torch.equal(single, sharded)
    print(f"correlate_images of the diagonal pair under the mesh, F of phase 6's unsharded"
          f" run: planes equal {same} (valid share {float(single[:, :, 2].float().mean()):.4f},"
          f" plan {plan})")
    if not same:
        raise AssertionError("the sharded perspective correlation differs from the unsharded one")
    check_sharded_plan("diagonal correlate_images under the mesh", plan, views[0].shape,
                       views[1].shape, mesh)
    return out


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
    check_sharded_plan("end to end under the mesh", e2e_mesh["plan"], img1.shape, img2.shape,
                       mesh)
    device_ms_mesh = profile_end_to_end(img1, img2, mesh, "profile under the mesh")
    phase_same_correlation(img1, img2, matches, mesh, device)
    print(f"multi-device phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    depth_map = phase_depth_map(img1, img2, disparity, e2e["xyz"], counters)
    texture_obj = phase_texture_obj(device, counters, gen)
    print(f"affine lanes phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    persp = phase_perspective(device, counters, gen)
    print(f"perspective phase took {time.perf_counter() - t0:.1f} s")
    b3, b5, full, diag = (persp["runs"][k] for k in ("baseline3", "baseline5", "full_width",
                                                     "diagonal"))

    t0 = time.perf_counter()
    persp_mesh = phase_mesh_perspective(mesh, device, counters, persp)
    print(f"perspective under the mesh phase took {time.perf_counter() - t0:.1f} s")
    b5_mesh, diag_mesh = persp_mesh["baseline5"], persp_mesh["diagonal"]

    def record(name, source, replaces, main, errs, run=e2e, dev_ms=device_ms,
               dev_name=None, large=None, at_persp=None):
        rec = {
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
        if large is not None:
            # Phase 5: launches per run of BASELINE #1 and #4, and the
            # kernel at #4's shapes.
            rec.update({
                "launches_baseline1": depth_map["launches"][name],
                "launches_baseline4": texture_obj["launches"][name],
                "device_ms_per_run_baseline4": texture_obj["device_ms"][name],
                **{f"{k}_baseline4": large[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            })
        if at_persp is not None:
            # Phase 6: launches per run of BASELINE #3, #5, the
            # full-width 3-view run and the diagonal pair, device ms in
            # their profiled runs, and the kernel at the path's shapes.
            rec.update({
                "launches_baseline3": b3["launches"][name],
                "launches_baseline5": b5["launches"][name],
                "launches_full_width": full["launches"][name],
                "launches_diagonal": diag["launches"][name],
                "device_ms_per_run_full_width": full["device_ms"][name],
                "device_ms_per_run_diagonal": diag["device_ms"][name],
                **{f"{k}_perspective": at_persp[k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            })
        return rec

    large = texture_obj["kernels"]
    kernels_line = {"kernels": [
        record("ncc_sweep", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:93", sweep["horiz"],
               [r["err"] for r in [*sweep.values(), *awkward, *wide,
                                   large["K1 horiz"], large["K1 vert"], persp["k1_pixel"]]],
               large=large["K1 horiz"], at_persp=persp["k1_pixel"]),
        record("score_candidates", "score_candidates.cu",
               "cybervision_tpu/ops/pallas_score.py:56", score_r[m_main],
               [r["err"] for r in [*score_r.values(), *score_awkward, large["K2"],
                                   persp["k2"]]],
               large=large["K2"], at_persp=persp["k2"]),
        dict(record("gather_packed", "gather_packed.cu",
                    "cybervision_tpu/ops/pallas_gather.py:60", gather_r[m_main],
                    [r["err"] for r in [*gather_r.values(), large["K3"], persp["k3"]]],
                    large=large["K3"], at_persp=persp["k3"]),
             **{k: gather_r[m_main][k] for k in (
                 "device_us_per_call", "library_device_us_per_call",
                 "host_us_per_call", "library_host_us_per_call")}),
        record("ncc_sweep_sharded", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:682", sharded["horiz"],
               [r["err"] for r in sharded.values()], run=e2e_mesh,
               dev_ms=device_ms_mesh, dev_name="ncc_sweep"),
    ]}
    kernels_line["kernels"][0].update({
        f"launches_{key}_per_pixel": r["launches"]["ncc_sweep_pixel"]
        for key, r in persp["runs"].items()
    })
    kernels_line["kernels"][0].update({
        f"device_ms_per_run_{key}_per_pixel": r["device_ms"]["ncc_sweep_pixel"]
        for key, r in (("full_width", full), ("diagonal", diag))
    })
    # Phase 7: K1s's per-pixel form on the diagonal pair under the mesh
    # (K1 launches per run, all per-pixel, and the sharded sweeps), its
    # device ms in the profiled run; K2/K3 and P3P's blocks per run there
    # and in BASELINE #5 under the mesh.
    for key, r in (("baseline5", b5_mesh), ("diagonal", diag_mesh)):
        kernels_line["kernels"][3].update({
            f"launches_mesh_{key}_per_pixel": r["launches"]["ncc_sweep_pixel"],
            f"sharded_calls_mesh_{key}": r["launches"]["ncc_sweep_sharded"],
            f"device_ms_per_run_mesh_{key}_per_pixel": r["device_ms"]["ncc_sweep_pixel"],
        })
        for rec in kernels_line["kernels"][1:3]:
            rec[f"launches_mesh_{key}"] = r["launches"][rec["name"]]
        kernels_line["kernels"][3][f"p3p_blocks_mesh_{key}"] = r["launches"]["p3p_score"]
    # The per-pixel form at 1024x1024 (phase 2's checkerboard of axes),
    # for K1 and over the mesh for K1s; "*_perspective" above is K1's
    # per-pixel form on the diagonal run's finest fields.
    for rec, r in ((kernels_line["kernels"][0], sweep["per-pixel"]),
                   (kernels_line["kernels"][3], sharded["per-pixel"])):
        rec.update({f"per_pixel_{k}": r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    print(f"end-to-end seconds (warm, best of 3): {e2e['seconds']:.4f} on one"
          f" card, {e2e_mesh['seconds']:.4f} over {mesh.describe()}; RANSAC"
          f" of all 20 rounds {ransac_full['seconds']:.4f} s; one round's draws"
          f" {draws['ms']:.4f} ms (torch.randint {draws['torch_randint_ms']:.4f} ms);"
          f" BASELINE #1 (PNG depth map) {depth_map['seconds']:.4f} s, best of 3;"
          f" BASELINE #4 (4032x3024 texture OBJ) {texture_obj['seconds']:.4f} s, best of 2;"
          f" BASELINE #3 (perspective pair -> OBJ) {b3['seconds']:.4f} s, best of 2;"
          f" BASELINE #5 (3-view SFM -> PLY) {b5['seconds']:.4f} s, best of 2;"
          f" 3 views at 1024x820 {full['seconds']:.4f} s, one run;"
          f" diagonal pair at 1024x820 {diag['seconds']:.4f} s, best of 2;"
          f" over {mesh.describe()}: BASELINE #5 {b5_mesh['seconds']:.4f} s and the diagonal"
          f" pair {diag_mesh['seconds']:.4f} s, best of 2")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
