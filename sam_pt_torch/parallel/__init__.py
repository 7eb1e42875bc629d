"""The port's parallel layer over `torch.distributed` (counterpart of
`sam_pt_tpu/parallel/`): meshes of ranks, data parallelism, the
tensor-parallel SAM encoder, time-sharded TapNet and TAPIR, and
evaluation sharded over processes."""
from .mesh import (
    batch_sharding,
    create_mesh,
    init_world,
    replicate,
    shard_batch,
)
from .eval_sharding import gather_host_results, shard_videos_across_hosts
