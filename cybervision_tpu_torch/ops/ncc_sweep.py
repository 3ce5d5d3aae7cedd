"""K1: the dense-NCC hypothesis sweep (counterpart of ops/pallas_ncc.py).

`ncc_sweep` launches csrc/ncc_sweep.cu on CUDA tensors and runs
`ncc_sweep_plain`, the same arithmetic in PyTorch, on CPU tensors.

Semantics (cybervision_tpu/ops/pallas_ncc.py:_sweep_kernel, whose scan
twin is correlation.refine_pass): per pixel p, for each stripe o
(outer) and offset u in [-window, window] (inner), the hypothesis at
q = p + u along the epipolar axis has candidate
(qx, qy) = (floor(coeff*center + add)(q) + o, center(q)) for a vertical
corridor, transposed for a horizontal one; its NCC is the 11x11 window
product of img1 with the stripe warp w0[o] shifted by u, normalised by
avg1/isd1 at p and the warp's own box statistics at q; masks are the
source band [KS, dim-KS), candidate bounds, the corridor
[start, end), p_ok, min_stdev and threshold; the first strict maximum
wins. axis "vert"/"horiz" fixes the epipolar axis; None reads it per
pixel from `vert` (the cross-axis hypothesis gate and per-element warp
shift of the per-pixel form).

The TPU kernel's row tiles, VMEM budget (pick_tile_h) and the
horizontal-axis transpose of refine_pass_pallas have no counterpart:
the CUDA kernel sweeps columns directly and takes every refine level.
All three forms run one block per output tile with every operand in
shared memory, staging the band of warp and fields the tile's shifts
read in chunks of offsets, so every window fits: the static forms one
band along their axis, the per-pixel form a row band and a column band
(each only where the tile needs it), one product plane per hypothesis
serving the pixels of both axes. `sweep_tile_plan` is that launch's
geometry (tile, grid, chunk, shared bytes), computed here so the CPU
tests reach it.

K1s, `ncc_sweep_sharded` (pallas_ncc.py:682-801), runs the same kernel
on the row shards of a parallel.Mesh: every shard's fields get their
neighbours' rows attached (parallel.sharding.halo) and the kernel's
row-halo form bounds its tests by global rows, so the sharded result
equals the unsharded one bit for bit.
"""

from __future__ import annotations

import functools
import math

import torch

from cybervision_tpu_torch import kernels
from cybervision_tpu_torch.parallel.sharding import (
    RowShards,
    assert_spans_mesh,
    halo,
    shard_rows,
)

KS = 5
KPC = (2 * KS + 1) ** 2
_AXES = {None: 0, "vert": 1, "horiz": 2}

# Kernel launches since the counter was last set to 0; a sharded call
# adds one per shard. pixel_launches counts those of the per-pixel form
# (axis None) among them.
launches = 0
pixel_launches = 0
# ncc_sweep_sharded calls on CUDA shards since the counter was last set
# to 0.
sharded_launches = 0

# csrc/ncc_sweep.cu's output tiles, 256 threads each: the static forms'
# are short along the sweep axis (the band of warp and fields they stage
# grows with the chunk of offsets along it), the per-pixel form's square
# (its bands grow along both axes). SMEM_LIMIT is the shared memory one
# block may hold on the H100 (227 KB).
TILES = {"horiz": (16, 64), "vert": (64, 16), None: (32, 32)}
TILE_THREADS = 256
SMEM_LIMIT = 232_448
# The per-pixel form's chunks stay within this many bytes: two blocks per
# SM (228 KB, less 1 KB per block), the fastest of the budgets that
# tools/k1_pixel_budget.py times on the H100.
PIXEL_SMEM_LIMIT = 115_712


def _box11(x: torch.Tensor) -> torch.Tensor:
    """11x11 window sums over the last two axes, zero outside: column
    offsets summed first, then row offsets, each in increasing order (the
    order of the Pallas kernel's _box11 and of the CUDA tiles)."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (KS, KS, KS, KS))
    acc = xp[..., :, 0:w]
    for d in range(1, 2 * KS + 1):
        acc = acc + xp[..., :, d : d + w]
    out = acc[..., 0:h, :]
    for d in range(1, 2 * KS + 1):
        out = out + acc[..., d : d + h, :]
    return out


def shift(x: torch.Tensor, u: int, dim: int, fill: int = 0) -> torch.Tensor:
    """out(p) = x(p + u e_dim), `fill` where p + u e_dim leaves the tensor."""
    if u == 0:
        return x
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(u) >= n:
        return out
    if u > 0:
        out.narrow(dim, 0, n - u).copy_(x.narrow(dim, u, n - u))
    else:
        out.narrow(dim, -u, n + u).copy_(x.narrow(dim, 0, n + u))
    return out


def _tile_smem(axis: str | None, span: int) -> int:
    """Shared bytes of one block whose chunk holds span + 1 offsets —
    csrc/ncc_sweep.cu's layout(): the img1 tile +- KS, the w0 band (+- KS,
    and + span along the axis), four per-q planes of the band, and the
    larger of the row-sum plane and the box sums' scratch. The per-pixel
    form (pixel_layout()) has both bands, each with its four planes, and
    a byte per element of the tile +- KS for its axis."""
    th, tw = TILES[axis]
    if axis is None:
        ir, ip = th + 2 * KS, tw + 2 * KS
        bands = (ir + span) * ip + ir * (ip + span)
        planes = 4 * (th + span) * tw + 4 * th * (tw + span)
        tmp = max(2 * (ir + span) * tw, 2 * ir * (tw + span), ir * tw)
        return 4 * (ir * ip + -(-ir * ip // 4) + bands + planes + tmp)
    sy, sx = (span, 0) if axis == "vert" else (0, span)
    ir, ip = th + 2 * KS, tw + 2 * KS
    wr, wp = th + 2 * KS + sy, tw + 2 * KS + sx
    br, bc = th + sy, tw + sx
    # A "vert" warp spans two 16-wide rows: 4 floats of padding per row.
    bp = bc + 4 if axis == "vert" else bc
    rp = tw + 4 if axis == "vert" else tw
    return 4 * (ir * ip + wr * wp + 4 * br * bp + max(ir * rp, 2 * wr * bp))


@functools.lru_cache(maxsize=None)
def _chunking(axis: str | None, window: int, limit: int) -> tuple[int, tuple, int]:
    """(chunk, chunks, shared bytes) of sweep_tile_plan."""
    n_off = 2 * window + 1
    chunk = n_off
    if _tile_smem(axis, n_off - 1) > limit:
        longest = max(c for c in range(1, n_off) if _tile_smem(axis, c - 1) <= limit)
        chunk = -(-n_off // -(-n_off // longest))
    chunks = tuple((u0, min(window, u0 + chunk - 1))
                   for u0 in range(-window, window + 1, chunk))
    return chunk, chunks, _tile_smem(axis, chunk - 1)


def sweep_tile_plan(h: int, w: int, window: int, axis: str | None) -> dict:
    """Launch geometry of a form ("vert", "horiz", or None for the
    per-pixel form) for an (h, w) plane: tile (rows, columns), grid
    (column tiles, row tiles) covering the plane, the chunk (offsets
    staged per band) and the block's shared bytes. A window whose whole
    band of 2 * window + 1 offsets fits one block sweeps it as one
    chunk; a wider one in the fewest chunks that fit, of equal length
    but the last. `chunks` lists each chunk's first and last offset, in
    the sweep's order. The per-pixel form first narrows each tile's
    offsets to those its pixels can admit and cuts that range into
    chunks of this length; `chunks` is then the cut of the widest range,
    the whole window."""
    if axis not in TILES:
        raise ValueError(f"sweep_tile_plan: axis must be vert, horiz or None, got {axis!r}")
    limit = PIXEL_SMEM_LIMIT if axis is None else SMEM_LIMIT
    chunk, chunks, smem = _chunking(axis, window, limit)
    th, tw = TILES[axis]
    return {
        "tile": (th, tw), "grid": (-(-w // tw), -(-h // th)),
        "threads": TILE_THREADS, "chunk": chunk, "chunks": chunks,
        "smem_bytes": smem,
    }


def _halo_rows(window: int) -> dict[str, int]:
    """Rows of neighbouring shards each field carries in the row-halo
    form: KS for the box filter of img1, `window` for the u-shifted
    fields, KS + window for the stripe warps (shift and box)."""
    return {"img1": KS, "vert": window, "center": window, "coeff": window,
            "add": window, "w0": KS + window}


def ncc_sweep_plain(
    img1, vert, center, coeff, add, avg1, isd1, start, end, p_ok, w0, *,
    threshold: float, min_stdev: float, window: int, corridor_size: int,
    h2: int, w2: int, axis: str | None, row_halo: bool = False,
    row0_g: int = 0, h_total: int | None = None,
):
    """The sweep in PyTorch: same inputs, outputs and rounding order as
    the CUDA kernel. Returns (best_corr f32, best_x i32, best_y i32).

    Row-halo form: every field is embedded in one plane of h + 2m rows
    (m = KS + window), its own halo rows kept and zeros beyond them —
    the values the kernel reads — and the source band tests global rows
    row0_g - m + i against h_total; the plane's inner h rows are the
    result."""
    h, w = avg1.shape
    dev = img1.device
    h_total = h if h_total is None else h_total
    m = KS + window if row_halo else 0
    if m:
        depth = _halo_rows(window)

        def embed(x, own):
            return torch.nn.functional.pad(x, (0, 0, m - own, m - own))

        img1, vert, center, coeff, add = (
            embed(x, depth[k]) for k, x in zip(
                ("img1", "vert", "center", "coeff", "add"),
                (img1, vert, center, coeff, add),
            )
        )
        avg1, isd1, start, end, p_ok = (
            embed(x, 0) for x in (avg1, isd1, start, end, p_ok)
        )
    hp = h + 2 * m
    inv_kpc = torch.tensor(1.0 / KPC, dtype=torch.float32, device=dev)
    rows = torch.arange(row0_g - m, row0_g - m + hp, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    off0 = torch.floor(coeff * center + add)
    pok = p_ok > 0.5
    vert_b = vert > 0.5
    best = torch.full((hp, w), -math.inf, dtype=torch.float32, device=dev)
    best_x = torch.zeros((hp, w), dtype=torch.int32, device=dev)
    best_y = torch.zeros((hp, w), dtype=torch.int32, device=dev)
    box = _box11(torch.stack([w0, w0 * w0]))
    for oi in range(w0.shape[0]):
        o_val = float(oi - corridor_size)
        planes = torch.stack([
            center, off0, box[0, oi], box[1, oi], vert,
        ])
        for u in range(-window, window + 1):
            if axis == "vert":
                sl, warp = shift(planes, u, -2), shift(w0[oi], u, -2)
                src_ok = (rows + u >= KS) & (rows + u < h_total - KS)
            elif axis == "horiz":
                sl, warp = shift(planes, u, -1), shift(w0[oi], u, -1)
                src_ok = (cols + u >= KS) & (cols + u < w - KS)
            else:
                sl = torch.where(
                    vert_b, shift(planes, u, -2), shift(planes, u, -1)
                )
                warp = torch.where(
                    vert_b, shift(w0[oi], u, -2), shift(w0[oi], u, -1)
                )
                src_ok = torch.where(
                    vert_b,
                    (rows + u >= KS) & (rows + u < h_total - KS),
                    (cols + u >= KS) & (cols + u < w - KS),
                )
            cen_u, off_u, s_w, s_ww, vert_u = sl.unbind(0)
            off = off_u + o_val
            if axis is None:
                qx = torch.where(vert_b, off, cen_u)
                qy = torch.where(vert_b, cen_u, off)
            else:
                qx, qy = (off, cen_u) if axis == "vert" else (cen_u, off)
            inb = (qx >= KS) & (qx < w2 - KS) & (qy >= KS) & (qy < h2 - KS)
            avg_w = s_w * inv_kpc
            var_w = torch.clamp(s_ww * inv_kpc - avg_w * avg_w, min=0.0)
            sd_w = torch.sqrt(var_w)
            cross = _box11(img1 * warp)
            corr = (cross * inv_kpc - avg1 * avg_w) * isd1 / torch.clamp(
                sd_w, min=1e-12
            )
            ok = (
                src_ok & inb & (cen_u >= start) & (cen_u < end) & pok
                & (sd_w >= min_stdev) & (corr >= threshold)
            )
            if axis is None:
                ok &= (vert_u > 0.5) == vert_b
            corr = torch.where(ok, corr, -math.inf)
            upd = corr > best
            best = torch.where(upd, corr, best)
            best_x = torch.where(upd, qx.to(torch.int32), best_x)
            best_y = torch.where(upd, qy.to(torch.int32), best_y)
    return best[m : m + h], best_x[m : m + h], best_y[m : m + h]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"ncc_sweep: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ncc_sweep: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"ncc_sweep: {name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"ncc_sweep: {name} must be contiguous")


def ncc_sweep(
    img1, vert, center, coeff, add, avg1, isd1, start, end, p_ok, w0, *,
    threshold: float, min_stdev: float, window: int, corridor_size: int,
    h2: int, w2: int, axis: str | None, row_halo: bool = False,
    row0_g: int = 0, h_total: int | None = None,
):
    """Best (corr f32, x i32, y i32) per pixel. Every field is an (H, W)
    float32 tensor (vert and p_ok as 0/1), w0 is (2*corridor_size+1, H,
    W) float32. CUDA tensors launch the kernel on their own device;
    CPU tensors run ncc_sweep_plain.

    row_halo=True is the form ncc_sweep_sharded launches per shard: H is
    the shard's rows (avg1, isd1, start, end, p_ok carry no halo), img1
    arrives with KS rows of the neighbouring shards above and below,
    vert/center/coeff/add with `window`, w0 with KS + window along its
    axis 1; row0_g is the shard's first global row and h_total the
    image's height, for the source-band and interior tests."""
    global launches, pixel_launches
    h, w = avg1.shape
    n_o = 2 * corridor_size + 1
    if axis not in _AXES:
        raise ValueError(f"ncc_sweep: axis must be vert, horiz or None, got {axis!r}")
    if window < KS:
        raise ValueError(f"ncc_sweep: window {window} below the NCC half-width {KS}")
    h_total = h if h_total is None else h_total
    depth = _halo_rows(window) if row_halo else dict.fromkeys(_halo_rows(window), 0)
    fields = dict(
        img1=img1, vert=vert, center=center, coeff=coeff, add=add,
        avg1=avg1, isd1=isd1, start=start, end=end, p_ok=p_ok,
    )
    dev = avg1.device
    for name, t in fields.items():
        _check(name, t, (h + 2 * depth.get(name, 0), w), dev)
    m_w0 = depth["w0"]
    _check("w0", w0, (n_o, h + 2 * m_w0, w), dev)
    kw = dict(
        threshold=threshold, min_stdev=min_stdev, window=window,
        corridor_size=corridor_size, h2=h2, w2=w2, axis=axis,
        row_halo=row_halo, row0_g=row0_g, h_total=h_total,
    )
    if dev.type == "cpu":
        return ncc_sweep_plain(*fields.values(), w0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"ncc_sweep: unsupported device {dev}")
    lib = kernels.library()
    plan = sweep_tile_plan(h, w, window, axis)
    (tile_h, tile_w), chunk, smem = plan["tile"], plan["chunk"], plan["smem_bytes"]
    corr = torch.empty((h, w), dtype=torch.float32, device=dev)
    bx = torch.empty((h, w), dtype=torch.int32, device=dev)
    by = torch.empty((h, w), dtype=torch.int32, device=dev)
    # The C entry point launches on the host thread's current device.
    with kernels.on_device(dev):
        kernels.check(
            lib.cv_ncc_sweep(
                *(t.data_ptr() for t in fields.values()), w0.data_ptr(),
                corr.data_ptr(), bx.data_ptr(), by.data_ptr(), h, w, n_o,
                corridor_size, window, h2, w2, _AXES[axis], float(threshold),
                float(min_stdev), depth["img1"], depth["center"], m_w0, row0_g,
                h_total, tile_h, tile_w, chunk, smem, kernels.stream_of(dev),
            ),
            "cv_ncc_sweep",
        )
    launches += 1
    pixel_launches += axis is None
    return corr, bx, by


def shardable_rows(rows: int, n_dev: int, window: int) -> bool:
    """Can an image of `rows` rows run the sharded sweep on n_dev shards?
    Each shard must be at least one halo deep (KS + window rows): the
    halo exchange is single hop (pallas_ncc.py:673-679)."""
    return -(-rows // n_dev) >= KS + window


def ncc_sweep_sharded(
    mesh, img1, vert, center, coeff, add, avg1, isd1, start, end, p_ok, w0, *,
    threshold: float, min_stdev: float, window: int, corridor_size: int,
    h2: int, w2: int, axis: str | None, plain: bool = False,
) -> tuple[RowShards, RowShards, RowShards]:
    """ncc_sweep over the row shards of a parallel.Mesh (K1s).

    Each field is a RowShards along the image rows (w0 along its axis 1)
    or a full tensor, which is sharded here. Every shard gets its
    neighbours' rows attached — KS for img1, `window` for vert, center,
    coeff and add, KS + window for w0, zeros at the global edges — and
    one K1 launches per shard on that shard's device, bounded by global
    rows; the result equals the unsharded sweep bit for bit. Returns
    RowShards of (corr, x, y). plain=True runs ncc_sweep_plain on every
    shard instead (the comparison on the card), launching nothing."""
    global sharded_launches
    given = dict(
        img1=img1, vert=vert, center=center, coeff=coeff, add=add,
        avg1=avg1, isd1=isd1, start=start, end=end, p_ok=p_ok, w0=w0,
    )
    shards = {
        k: v if isinstance(v, RowShards) else shard_rows(mesh, v, 1 if k == "w0" else 0)
        for k, v in given.items()
    }
    h = shards["avg1"].h
    for k, v in shards.items():
        assert_spans_mesh(v, mesh)
        if (v.h, v.axis) != (h, 1 if k == "w0" else 0):
            raise ValueError(f"ncc_sweep_sharded: {k} shards {v.h} rows along axis {v.axis}")
    if not shardable_rows(h, mesh.size, window):
        raise ValueError(
            f"ncc_sweep_sharded: {h} rows over {mesh.size} shards are shallower"
            f" than one halo ({KS + window} rows)"
        )
    depth = _halo_rows(window)
    parts = {k: halo(v, depth.get(k, 0)) for k, v in shards.items()}
    hs = shards["avg1"].hs
    sweep = ncc_sweep_plain if plain else ncc_sweep
    outs = [
        sweep(
            *(parts[k][i] for k in given), threshold=threshold,
            min_stdev=min_stdev, window=window, corridor_size=corridor_size,
            h2=h2, w2=w2, axis=axis, row_halo=True, row0_g=i * hs, h_total=h,
        )
        for i in range(mesh.size)
    ]
    if not plain and mesh.lead.type == "cuda":
        sharded_launches += 1
    return tuple(RowShards(tuple(o[j] for o in outs), h, hs) for j in range(3))
