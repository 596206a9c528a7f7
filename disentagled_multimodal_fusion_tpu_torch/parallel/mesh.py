"""The mesh: the ranks of a ``torch.distributed`` process group as a
(data, model) grid, and the row and instance slicing of its ``data`` axis.

Counterpart of ``disentagled_multimodal_fusion_tpu/parallel/mesh.py``.
The ``data`` axis has the JAX meaning of one program over the global batch,
split by rows:

* a single fit (``core.train.train(mesh=)``) splits every step's rows over
  it, each rank holding the dataset whole: :func:`split_rows` /
  :func:`rows_of` (the counterparts of ``batch_sharding`` and
  ``shard_batch``);
* a seed-batched fit (``train_many(mesh=)``, the one-program cell) splits
  the instance axis, S / n_dp instances a rank: :func:`instances_of` /
  :func:`shard_instances` (``instance_sharding``, ``shard_instances``);
* serving splits a request's rows.

The ``model`` axis (the Megatron cut of every MLP's hidden width,
``param_sharding_rule`` and ``shard_params`` in the JAX package) is not
ported yet: a mesh with ``model`` > 1 raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

from .distributed import rank, world_size

MODEL_AXIS_NOT_PORTED = ("the mesh's 'model' axis (tensor parallelism, --model-parallel > 1) "
                         "is not ported yet (see ROADMAP.md)")


class Mesh:
    """This rank's view of an n-device mesh with axes ("data", "model"):
    ``shape`` maps each axis to its size, ``data_index`` is this rank's
    position along ``data``."""

    axis_names = ("data", "model")

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0):
        if model != 1:
            raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
        self.shape = {"data": int(data), "model": int(model)}
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The mesh over the ranks of the process group (one rank per device),
    shaped (n_devices // model_parallel, model_parallel). ``n_devices``
    defaults to the group's size and must equal it: a rank outside the
    mesh would have no part of the work."""
    n = n_devices or world_size()
    if n % model_parallel:
        raise ValueError("n_devices must divide by model_parallel")
    if model_parallel != 1:
        raise NotImplementedError(MODEL_AXIS_NOT_PORTED)
    if n != world_size():
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks, one per device; this process group has "
            f"{world_size()} (launch the ranks with torchrun --nproc-per-node {n}, or set RANK, "
            f"WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT for each)")
    return Mesh(n // model_parallel, model_parallel, rank())


def split_rows(n: int, parts: int) -> tuple:
    """Contiguous (lo, hi) bounds of n rows over ``parts`` ranks, sizes
    differing by at most one (the first n % parts ranks hold one more); a
    rank holds no rows only when n < parts."""
    per, extra = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + per + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return tuple(bounds)


def rows_of(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a length-n batch under :func:`split_rows`."""
    lo, hi = split_rows(n, mesh.shape["data"])[mesh.data_index]
    return slice(lo, hi)


def instances_of(s_count: int, mesh: Mesh, what: str = "train_many(mesh=...)",
                 noun: str = "instance count") -> slice:
    """This rank's block of S stacked instances, S / n_dp of them. Raises
    ``ValueError`` unless S divides by the ``data`` axis."""
    n_dp = mesh.shape["data"]
    if s_count % n_dp != 0:
        raise ValueError(
            f"{what}: {noun} {s_count} must divide by the mesh 'data' axis ({n_dp}); pad the "
            f"seed list or shrink the mesh")
    per = s_count // n_dp
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _slice_tree(tree, sl: slice):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, sl) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice_tree(v, sl) for v in tree)
    return tree[sl]


def shard_batch(tree, mesh: Mesh):
    """This rank's rows (:func:`rows_of`) of every leaf of ``tree`` (dicts,
    tuples and lists of tensors or arrays with rows first)."""
    leaf = tree
    while isinstance(leaf, (dict, tuple, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return _slice_tree(tree, rows_of(leaf.shape[0], mesh))


def shard_instances(tree, mesh: Mesh, s_count: int, what: str = "train_many(mesh=...)"):
    """This rank's instances (:func:`instances_of`) of every leaf of
    ``tree``, whose leading axis is the S stacked instances."""
    return _slice_tree(tree, instances_of(s_count, mesh, what))
