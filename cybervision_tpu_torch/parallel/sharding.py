"""Row shards over a Mesh (counterpart of cybervision_tpu/parallel/
sharding.py and of the halo exchange in pallas_ncc.py:ncc_sweep_sharded).

`shard_rows` cuts a tensor into equal row blocks (zero rows appended so
the mesh size divides it) and puts block i on the mesh's device i;
`halo` attaches to every block the rows of its neighbours, with zero rows
at the global top and bottom — what jax.lax.ppermute's zero fill gives
the JAX kernel, and the zero padding the unsharded sweep sees there;
`gather_rows` brings the blocks back to the lead device. For a level
that lives row-sharded (the counterparts of constrain_rows and of what
GSPMD inserts around it, cybervision_tpu/parallel/sharding.py:41-52):
`all_gather_rows` puts the whole tensor on every shard's device, one
copy per distinct device, for operands read at arbitrary rows;
`row_window` brings any global row range to one device (a halo of any
depth, `fill` outside the tensor); `tree_sum` reduces in one fixed
pairwise order, so that per-row partials sum to the same bits however
the rows were cut. The modules that shard own their sharded variants
and call these primitives.
"""

from __future__ import annotations

import dataclasses

import torch

from cybervision_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class RowShards:
    """parts[i] is rows [i*hs, (i+1)*hs) along `axis` of an h-row tensor
    zero-padded to len(parts)*hs rows."""

    parts: tuple[torch.Tensor, ...]
    h: int
    hs: int
    axis: int = 0


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> RowShards:
    """x cut into mesh.size row blocks of hs = ceil(h / n) rows along
    `axis`, block i contiguous on mesh.devices[i]."""
    n = mesh.size
    h = x.shape[axis]
    hs = -(-h // n)
    pad = n * hs - h
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    parts = tuple(
        x.narrow(axis, i * hs, hs).to(d).contiguous()
        for i, d in enumerate(mesh.devices)
    )
    return RowShards(parts, h, hs, axis)


def replicate(mesh: Mesh, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """x on every mesh device: one copy per distinct device, shared by
    the shards that live there."""
    copies = {d: x.to(d) for d in dict.fromkeys(mesh.devices)}
    return tuple(copies[d] for d in mesh.devices)


def gather_rows(shards: RowShards, device) -> torch.Tensor:
    """The h-row tensor on `device`: the blocks concatenated, the padding
    rows cut away."""
    parts = [p.to(device) for p in shards.parts]
    full = parts[0] if len(parts) == 1 else torch.cat(parts, dim=shards.axis)
    return full.narrow(shards.axis, 0, shards.h)


def all_gather_rows(shards: RowShards, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """The h-row tensor on every mesh device, for the shards that read
    it at arbitrary rows: one copy per distinct device (on a one-card
    mesh one copy in all), entry i on mesh.devices[i]."""
    assert_spans_mesh(shards, mesh)
    copies = {d: gather_rows(shards, d) for d in dict.fromkeys(mesh.devices)}
    return tuple(copies[d] for d in mesh.devices)


def row_window(shards: RowShards, lo: int, hi: int, device, fill=0) -> torch.Tensor:
    """Global rows [lo, hi) along the shard axis on `device`: the rows
    inside [0, h) copied from the blocks that hold them, `fill` for the
    rows outside (above the top, and below row h, where the last block's
    padding rows count as outside)."""
    ax, hs = shards.axis, shards.hs
    pieces = []
    if lo < 0:
        pieces.append(_fill_rows(shards.parts[0], min(hi, 0) - lo, ax, fill, device))
    a, b = max(lo, 0), min(hi, shards.h)
    while a < b:
        i = a // hs
        e = min(b, (i + 1) * hs)
        pieces.append(shards.parts[i].narrow(ax, a - i * hs, e - a).to(device))
        a = e
    if hi > max(shards.h, lo):
        pieces.append(_fill_rows(shards.parts[0], hi - max(shards.h, lo), ax, fill, device))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=ax)


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` in a fixed pairwise order: zero-pad the axis to a
    power of two, then add its halves until one element is left. Each
    output element's additions depend only on the values along `dim`,
    never on the other axes' sizes, the device or a library's choice of
    reduction tree, so partial sums cut at any rows reduce to the same
    bits. `dim` is removed."""
    n = x.shape[dim]
    p = 1
    while p < n:
        p *= 2
    if p > n:
        shape = list(x.shape)
        shape[dim] = p - n
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x.squeeze(dim)


def halo(shards: RowShards, m: int) -> tuple[torch.Tensor, ...]:
    """Every block with m rows of the previous block above it and m rows
    of the next one below it, zero rows at the global top and bottom
    (single hop: m must not exceed hs). Block i's result has hs + 2m
    rows along the shard axis and lives on block i's device."""
    if m > shards.hs:
        raise ValueError(f"a halo of {m} rows exceeds the {shards.hs}-row shards")
    parts, ax = shards.parts, shards.axis
    if m == 0:
        return parts
    out = []
    for i, p in enumerate(parts):
        top = (
            parts[i - 1].narrow(ax, shards.hs - m, m).to(p.device)
            if i > 0 else _fill_rows(p, m, ax, 0, p.device)
        )
        bot = (
            parts[i + 1].narrow(ax, 0, m).to(p.device)
            if i + 1 < len(parts) else _fill_rows(p, m, ax, 0, p.device)
        )
        out.append(torch.cat([top, p, bot], dim=ax))
    return tuple(out)


def _fill_rows(p: torch.Tensor, m: int, axis: int, fill, device) -> torch.Tensor:
    shape = list(p.shape)
    shape[axis] = m
    return torch.full(shape, fill, dtype=p.dtype, device=device)


def assert_spans_mesh(shards: RowShards, mesh: Mesh) -> None:
    """Raise unless there is one block per mesh device and block i lies
    on mesh.devices[i] — no stage silently runs on fewer devices."""
    devs = tuple(p.device for p in shards.parts)
    if devs != mesh.devices:
        raise AssertionError(
            f"shards on {devs} do not span the mesh {mesh.devices}"
        )
