"""Multi-device execution of the port: a single-process device mesh and
row-sharding helpers (counterpart of cybervision_tpu/parallel)."""

from cybervision_tpu_torch.parallel.mesh import (
    AUTO,
    Mesh,
    pipeline_mesh,
    resolve_mesh,
    use_mesh,
)
from cybervision_tpu_torch.parallel.sharding import (
    RowShards,
    all_gather_rows,
    assert_spans_mesh,
    gather_rows,
    halo,
    replicate,
    row_window,
    shard_rows,
    tree_sum,
)

__all__ = [
    "AUTO",
    "Mesh",
    "RowShards",
    "all_gather_rows",
    "assert_spans_mesh",
    "gather_rows",
    "halo",
    "pipeline_mesh",
    "replicate",
    "resolve_mesh",
    "row_window",
    "shard_rows",
    "tree_sum",
    "use_mesh",
]
