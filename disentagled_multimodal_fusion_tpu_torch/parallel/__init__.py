"""The mesh over ``torch.distributed`` ranks: its ``data`` axis (row and
seed splits), its ``model`` axis (the Megatron cut of the hidden widths,
``param_sharding_rule`` and ``shard_params`` as in the JAX package),
multi-process start-up and host-local data feeding (the JAX package's
``parallel``)."""

from .distributed import (
    global_mesh,
    host_local_block,
    initialize,
    place_global,
    process_rows,
)
from .mesh import (
    Mesh,
    ShardPlan,
    make_mesh,
    model_split,
    param_sharding_rule,
    rows_of,
    shard_batch,
    shard_instances,
    shard_params,
    split_rows,
)
