"""Data parallelism over `torch.distributed` (counterpart of
`dh3d_tpu.parallel`): collectives with autograd built from `all_reduce`
(`collectives`), process meshes and the batch and state placement
(`mesh`), the point-sharded kNN (`sharded_knn`), and the launcher of one
process a rank (`launch`, imported on its own: it reaches the trainer)."""

from dh3d_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    position,
    size,
)
from dh3d_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_parallel_mesh,
    multihost_mesh,
    placement,
    replicate,
    shard_batch,
)
from dh3d_tpu_torch.parallel.sharded_knn import (  # noqa: F401
    knn_sharded,
    point_block,
)
