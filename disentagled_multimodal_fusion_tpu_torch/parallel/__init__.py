"""The mesh's ``data`` axis over ``torch.distributed`` ranks, multi-process
start-up and host-local data feeding (the JAX package's ``parallel``; its
``model`` axis, ``param_sharding_rule`` and ``shard_params``, is not
ported yet)."""

from .distributed import (
    global_mesh,
    host_local_block,
    initialize,
    place_global,
    process_rows,
)
from .mesh import (
    Mesh,
    make_mesh,
    rows_of,
    shard_batch,
    shard_instances,
    split_rows,
)
