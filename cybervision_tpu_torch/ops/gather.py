"""K3: packed coordinate-table gather (counterpart of ops/pallas_gather.py).

`gather_packed` launches csrc/gather_packed.cu on CUDA tensors and runs
`gather_packed_plain` (torch.take on each table row) on CPU tensors.
Both return exactly take(table, idx, axis=1).

The JAX package gates its Pallas gather to tables of at most 8192 rows
(a TPU cost that grows with M). The CUDA kernel takes any M, reading the
table through the L1/L2 caches, so the main path runs the kernel at every
match bucket.

A launch moves ~31 MB in ~11 us on the card, so the host's share of a
call matters: the device switch is skipped when the table's device is
current, and the stream is read as a raw pointer.
"""

from __future__ import annotations

import torch

from cybervision_tpu_torch import kernels

# Kernel launches since the counter was last set to 0.
launches = 0


def gather_packed_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = idx.reshape(-1).long()
    return torch.stack(
        [torch.take(table[0], flat), torch.take(table[1], flat)]
    ).reshape((2,) + tuple(idx.shape))


def gather_packed(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take(table, idx, axis=1) for a (2, M) int32 table and int32
    indices in [0, M) of any shape; returns (2,) + idx.shape int32. CUDA
    tensors launch the kernel on their own device; CPU tensors run
    gather_packed_plain."""
    global launches
    dev = idx.device
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("gather_packed: table and idx must be int32")
    if table.ndim != 2 or table.shape[0] != 2:
        raise ValueError(f"gather_packed: table must be (2, M), got {tuple(table.shape)}")
    if table.device != dev:
        raise ValueError("gather_packed: table and idx must share one device")
    if dev.type == "cpu":
        return gather_packed_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather_packed: unsupported device {dev}")
    tbl = table.contiguous()
    flat = idx.contiguous()
    out = torch.empty((2,) + tuple(idx.shape), dtype=torch.int32, device=dev)
    # The C entry point launches on the host thread's current device.
    with kernels.on_device(dev):
        err = kernels.library().cv_gather_packed(
            tbl.data_ptr(), tbl.shape[1], flat.data_ptr(), flat.numel(),
            out.data_ptr(), kernels.stream_of(dev))
    kernels.check(err, "cv_gather_packed")
    launches += 1
    return out
