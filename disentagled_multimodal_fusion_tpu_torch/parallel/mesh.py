"""The mesh: the ranks of a ``torch.distributed`` process group as a
(data, model) grid, the row and instance slicing of its ``data`` axis, and
the Megatron cut of its ``model`` axis.

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

The ``model`` axis is the Megatron cut of every MLP's hidden width
(``train(mesh=, tp_hidden_dim=)``). The rule is the JAX package's, read
on each parameter in the flax layout (``convert.param_layouts``, the
layouts ``convert.py`` carries a flax tree over by): a kernel whose last
axis is the hidden width is column-parallel, else one whose axis before
the last is that width row-parallel, a 1-D tensor of that width is cut,
and everything else is whole on every rank (:func:`param_sharding_rule`).
A model group (the ``model`` ranks of one data index, a contiguous run of
ranks as the JAX package lays its devices out) trains 1/M of each such
tensor: :func:`shard_params` gives this rank's block, and :class:`ShardPlan`
carries the blocks through a fit, during which the model holds no storage
for the parameters the plan cuts (``core.train``), so a rank holds 1/M of
each of them and of its Adam moments, as a JAX device holds its shards.
The modules that take their blocks
(``models.layers.TorchLinear`` and ``models.dmvae_fused.StackedMLP``, the
MLPs) run the Megatron cut inside :func:`model_split`; every other
parameter the rule cuts (convolutions, BatchNorm scales, the fusion ops'
tensors) is gathered whole before the forward (:meth:`ShardPlan.call_params`).
GSPMD keeps the math of one device, and so does this.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..convert import IDENTITY, Layout, param_layouts
from .distributed import from_model, mesh_groups, placed, rank, world_size


class Mesh:
    """This rank's view of an n-device mesh with axes ("data", "model"):
    ``shape`` maps each axis to its size, ``data_index`` and ``model_index``
    are this rank's position. ``data_group`` is the process group of the
    ranks of this rank's model index (None: every rank, when ``model`` is
    1), ``model_group`` that of the ranks of its data index. A mesh with a
    ``model`` axis gets its groups from :func:`make_mesh`."""

    axis_names = ("data", "model")

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0, groups=None):
        self.shape = {"data": int(data), "model": int(model)}
        self.rank = int(rank)
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    def _group(self, i: int):
        if self.shape["model"] == 1:
            return None
        if self._groups is None:
            raise RuntimeError(f"{self!r} has a 'model' axis but no process groups: build it "
                               f"with make_mesh")
        return self._groups[i]

    @property
    def data_group(self):
        return self._group(0)

    @property
    def model_group(self):
        return self._group(1)

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The mesh over the ranks of the process group (one rank per device),
    shaped (n_devices // model_parallel, model_parallel). ``n_devices``
    defaults to the group's size and must equal it: a rank outside the
    mesh would have no part of the work. Every rank calls it alike (a
    ``model`` axis creates the mesh's process groups)."""
    n = n_devices or world_size()
    if n % model_parallel:
        raise ValueError("n_devices must divide by model_parallel")
    if n != world_size():
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks, one per device; this process group has "
            f"{world_size()} (launch the ranks with torchrun --nproc-per-node {n}, or set RANK, "
            f"WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT for each)")
    data, r = n // model_parallel, rank()
    groups = None
    if model_parallel > 1:
        data_groups, model_groups = mesh_groups(data, model_parallel)
        groups = (data_groups[r % model_parallel], model_groups[r // model_parallel])
    return Mesh(data, model_parallel, r, groups)


# ------------------------------------------------------------ the model axis
def param_sharding_rule(hidden_dim: int, instance_axis: Optional[str] = None):
    """The JAX package's rule: ``rule(shape)`` (a shape, or anything with a
    ``.shape``, in the flax layout) -> its partition spec as a tuple of
    axis names and None, ``()`` for a tensor whole on every rank. A kernel
    whose last axis is ``hidden_dim`` is cut on it (column-parallel), else
    one whose axis before the last is ``hidden_dim`` is cut there
    (row-parallel); a 1-D tensor of that width is cut; leading stacked axes
    (modalities, seeds) come along. ``instance_axis`` names a mesh axis to
    cut the leading axis over."""
    head = (instance_axis,) if instance_axis is not None else ()

    def rule(x) -> tuple:
        shape = tuple(getattr(x, "shape", x))
        body = len(shape) - len(head)
        if body >= 2:
            if shape[-1] == hidden_dim:
                return (*head, *([None] * (body - 1)), "model")
            if shape[-2] == hidden_dim:
                return (*head, *([None] * (body - 2)), "model", None)
        if body == 1 and shape[-1] == hidden_dim:
            return (*head, "model")
        if head and shape:
            return (*head, *([None] * (len(shape) - 1)))
        return ()

    return rule


class ModelSplit(NamedTuple):
    """The model axis as the layers see it inside :func:`model_split`: the
    hidden width ``hidden`` is cut into ``size`` blocks, this rank holding
    block ``index``; ``group`` is the model group."""

    hidden: int
    index: int
    size: int
    group: Any

    def kind(self, width_in: int, width_out: int) -> Optional[str]:
        """The rule on a Dense kernel (width_in, width_out): 'column',
        'row' or None (whole)."""
        if width_out == self.hidden:
            return "column"
        if width_in == self.hidden:
            return "row"
        return None

    def block(self, width: int) -> slice:
        """This rank's block of an axis ``width`` long."""
        k = width // self.size
        return slice(self.index * k, (self.index + 1) * k)


_MODEL_SPLIT: contextvars.ContextVar = contextvars.ContextVar("model_split", default=None)


@contextlib.contextmanager
def model_split(split: Optional[ModelSplit]):
    """Within the block, the layers that take their blocks of the model axis
    (``takes_model_blocks``) read ``split`` through
    :func:`current_model_split` and run the Megatron cut."""
    token = _MODEL_SPLIT.set(split)
    try:
        yield split
    finally:
        _MODEL_SPLIT.reset(token)


def current_model_split() -> Optional[ModelSplit]:
    """The model split of the step running now (None outside one)."""
    return _MODEL_SPLIT.get()


def _cut_axis(name: str, jax_shape, hidden: int, size: int) -> Optional[int]:
    """The flax axis the rule cuts (None: whole); raises ``ValueError`` when
    the model axis does not divide it, as the JAX package's placement
    does."""
    spec = param_sharding_rule(hidden)(jax_shape)
    if "model" not in spec:
        return None
    axis = spec.index("model")
    if jax_shape[axis] % size:
        raise ValueError(
            f"the model axis ({size}) does not divide the hidden width {jax_shape[axis]} of "
            f"{name} {tuple(jax_shape)}: pick --model-parallel to divide it")
    return axis


def _block(t: torch.Tensor, layout: Layout, axis: int, index: int, size: int) -> torch.Tensor:
    j = layout.to_jax(t)
    k = j.shape[axis] // size
    return layout.to_port(j.narrow(axis, index * k, k)).contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, hidden_dim: int,
                 layouts: Optional[Dict[str, Layout]] = None) -> Dict[str, torch.Tensor]:
    """This rank's block of every tensor of ``params`` (by name, the port's
    layout) under :func:`param_sharding_rule` on its flax layout
    (``layouts``, from ``convert.param_layouts``; flax's own without): the
    JAX ``shard_params`` array's shard on the device at this rank's mesh
    position, in the port's layout. The tensors the rule leaves whole come
    back as they are."""
    layouts = layouts or {}
    size, index = mesh.shape["model"], mesh.model_index
    out = {}
    for name, t in params.items():
        layout = layouts.get(name, IDENTITY)
        axis = _cut_axis(name, layout.to_jax(t).shape, hidden_dim, size)
        out[name] = t if axis is None else _block(t, layout, axis, index, size)
    return out


class _Cut(NamedTuple):
    layout: Layout
    axis: int          # the flax axis cut
    takes_block: bool  # its module runs the Megatron cut on the block


class ShardPlan:
    """The model axis of one fit: which of ``names`` (trainable parameters
    of ``model``) the rule cuts on the mesh's model axis at ``hidden_dim``,
    and how each rank holds, gathers and feeds them. Raises ``ValueError``
    when the model axis does not divide a width the rule cuts."""

    def __init__(self, model: torch.nn.Module, names, mesh: Mesh, hidden_dim: int):
        layouts = param_layouts(model)
        params = dict(model.named_parameters())
        owners = {f"{prefix}.{n}" if prefix else n: getattr(m, "takes_model_blocks", False)
                  for prefix, m in model.named_modules()
                  for n, _ in m.named_parameters(recurse=False)}
        self.split = ModelSplit(hidden_dim, mesh.model_index, mesh.shape["model"],
                                mesh.model_group)
        self.cuts = {}
        for name in names:
            shape = layouts[name].to_jax(params[name]).shape
            axis = _cut_axis(name, shape, hidden_dim, self.split.size)
            if axis is not None:
                self.cuts[name] = _Cut(layouts[name], axis, owners[name])

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole parameter (or moment) ``t``."""
        cut = self.cuts.get(name)
        if cut is None:
            return t
        return _block(t, cut.layout, cut.axis, self.split.index, self.split.size)

    def _gathered(self, local: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``names`` from each rank's blocks, in one
        collective over the model group; the backward gives each block its
        part of the gradient."""
        if not names:
            return {}
        s = self.split
        pieces, shapes = [], []
        for name in names:
            cut = self.cuts[name]
            j = cut.layout.to_jax(local[name])
            k = j.shape[cut.axis]
            whole = placed(j, cut.axis, s.index * k, s.size * k)
            shapes.append(whole.shape)
            pieces.append(whole.reshape(-1))
        flat = from_model(torch.cat(pieces), s)
        out, at = {}, 0
        for name, shape in zip(names, shapes):
            n = shape.numel()
            out[name] = self.cuts[name].layout.to_port(flat[at:at + n].view(shape))
            at += n
        return out

    def call_params(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The parameters the forward runs on: the blocks of the modules
        that run the Megatron cut, every other cut parameter gathered whole
        (gather-on-use; what uses it runs the same on every rank of the
        group, so each block's gradient is its part of that whole one)."""
        gather = [n for n, c in self.cuts.items() if not c.takes_block]
        return {**local, **self._gathered(local, gather)}

    @torch.no_grad()
    def whole(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every tensor of ``local`` (blocks by parameter name) whole."""
        return {**local, **self._gathered(local, [n for n in local if n in self.cuts])}


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
