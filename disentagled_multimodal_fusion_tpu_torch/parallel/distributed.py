"""Multi-process start-up, host-local data feeding, the mesh's process
groups and the collectives of its ``data`` and ``model`` axes.

Counterpart of ``disentagled_multimodal_fusion_tpu/parallel/distributed.py``.
JAX runs a mesh as one program over many devices; torch's idiom is one
process per device. So a mesh of n devices here is n ranks of a
``torch.distributed`` process group, each rank on its own device (or, over
gloo, several ranks on one card or on the CPU).

1. **Start-up.** :func:`initialize` joins the group from torch's standard
   environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
   ``MASTER_PORT``; ``torchrun`` sets them), the counterpart of
   ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
   Without that environment it is a no-op, so runners call it
   unconditionally; a second call finds the live group.
2. **Host-local feeding.** :func:`process_rows` and :func:`host_local_block`
   are the JAX package's numpy helpers (its lines 168-199): a loader reads
   only its rank's contiguous rows. :func:`place_global` keeps the JAX
   guard against a leading axis that does not divide over the processes.
3. **Collectives.** Only ``all_reduce`` (a sum) and ``broadcast`` are used,
   the two that gloo runs on CUDA tensors, so one code path runs over NCCL
   across cards and over gloo with two ranks on one card. A gather is a sum
   into a zero-filled buffer (adding zeros is exact). :func:`all_reduce`
   with ``differentiable=True`` sums the gradient in the backward too, which
   is the gradient of the sum of every rank's loss. Every collective takes
   a ``group``: None is every rank, else one of the mesh's groups
   (:func:`mesh_groups`).
4. **The model axis** (the Megatron cut of the hidden widths): the
   autograd pairs of ``parallel.mesh.ModelSplit``'s group, with
   :func:`to_model` (identity forward, sum backward) before a column layer
   whose input every rank of the group holds whole, :func:`from_model` (sum
   forward, identity backward) after a row layer's partial product,
   :func:`gather_from_model` (each rank's block of an axis gathered into
   the whole; backward, this rank's block of the gradient, summed over the
   group first when the consumer is a column layer) and
   :func:`scatter_to_model` (this rank's block of a whole tensor; backward,
   the blocks' gradients gathered).

A data-parallel step (``core.train.train(mesh=)``) runs its loss on this
rank's part of the global batch inside :func:`row_split`; the terms that
couple rows (BatchNorm's moments, SupCon's negatives, the orthogonality
penalty) read :func:`current_row_split` and take their global form.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import datetime
import os
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the environment a launcher (torchrun, or a test spawning ranks) sets
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a lost rank fails the run after this long instead of hanging it
DEFAULT_TIMEOUT_S = 600.0


def cluster_env() -> Optional[dict]:
    """The launcher's variables, or None when any is missing."""
    if not all(os.environ.get(k) for k in CLUSTER_ENV):
        return None
    return {k: os.environ[k] for k in CLUSTER_ENV}


def local_rank() -> int:
    """This rank's index on its machine (``LOCAL_RANK``; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` when named, else the
    card ``cuda:{LOCAL_RANK}``; raises without a card (the CPU is used only
    when asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (or --device cpu) "
                           "and the gloo backend to run the ranks on the CPU")
    return torch.device("cuda", local_rank())


def default_backend(dev: torch.device, named: bool) -> str:
    """NCCL where each rank of this machine has a card of its own, else
    gloo: on the CPU, and where ranks share a card (NCCL refuses two ranks on
    one card). Ranks share one when this machine runs more of them
    (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``) than it has cards, or when
    the device is ``named`` with an index while several ranks run here:
    every rank is given the same arguments, so they all name that card. The
    inputs are the same on every rank of a machine, so its ranks agree."""
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or os.environ.get("WORLD_SIZE") or 1)
    shared = local > torch.cuda.device_count() or (named and dev.index is not None and local > 1)
    return "gloo" if shared else "nccl"


def initialize(backend: Optional[str] = None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; a no-op without a cluster environment.

    ``backend``: ``"nccl"`` or ``"gloo"``; by default the one
    :func:`default_backend` picks for this rank's device (:func:`rank_device`
    of ``device``). ``timeout`` bounds the rendezvous and every collective.
    Returns True when a group of more than one rank is live; safe to call
    more than once.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = cluster_env()
    if env is None:
        return False
    dev = rank_device(device)
    if backend is None:
        backend = default_backend(dev, named=device is not None)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
        timeout=datetime.timedelta(seconds=timeout))
    atexit.register(finalize)
    return dist.get_world_size() > 1


def finalize() -> None:
    """Leave the process group (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes the run's files (rank 0, or the only
    process): two ranks writing one checkpoint at once can tear it."""
    return rank() == 0


def mesh_groups(data: int, model: int):
    """(data groups, model groups) of a (data, model) mesh over the whole
    process group: model group i holds ranks [i * model, (i + 1) * model)
    (a contiguous run, as the JAX package lays its devices out), data group
    j the ranks j, j + model, ... . Every rank creates every group, in this
    order, as ``dist.new_group`` requires; a second call for the same shape
    returns the same groups."""
    key = (data, model)
    if key not in _GROUPS:
        model_groups = [dist.new_group(list(range(i * model, (i + 1) * model)))
                        for i in range(data)]
        data_groups = [dist.new_group(list(range(j, data * model, model)))
                       for j in range(model)]
        _GROUPS[key] = (data_groups, model_groups)
    return _GROUPS[key]


_GROUPS: dict = {}


def group_size(group) -> int:
    """The number of ranks in ``group`` (None: every rank; 1 without a
    process group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def global_mesh(model_parallel: int = 1):
    """The mesh over every rank of the group, shaped (world / model_parallel,
    model_parallel)."""
    from .mesh import make_mesh

    n = world_size()
    if n % model_parallel:
        raise ValueError(f"device count {n} must divide by model_parallel={model_parallel}")
    return make_mesh(n, model_parallel=model_parallel)


# ------------------------------------------------------------ host-local feeding
def process_rows(n: int, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None) -> slice:
    """This process's contiguous row range of a length-n global axis
    (ceil-sized blocks). ``process_id`` / ``num_processes`` default to the
    live group's rank and size."""
    pc = world_size() if num_processes is None else num_processes
    pid = rank() if process_id is None else process_id
    per = -(-n // pc)  # ceil
    return slice(pid * per, min(n, (pid + 1) * per))


def host_local_block(arr, spec: Sequence, process_id=None, num_processes=None):
    """This process's block of a global array under ``spec`` (a partition
    spec as a tuple of axis names, e.g. ``("data",)``): a leading ``"data"``
    axis gives the process's contiguous rows, a replicated or inner-only spec
    the array whole."""
    if len(spec) == 0 or spec[0] is None:
        return arr
    return arr[process_rows(arr.shape[0], process_id, num_processes)]


def place_global(x, spec: Sequence):
    """This rank's block of the global array ``x`` under ``spec``, as a
    tensor (the JAX function's ``mesh`` is the process group here). A leading axis that is split must divide evenly over the
    processes: the ceil-sized blocks would otherwise differ in size."""
    arr = np.asarray(x)
    pc = world_size()
    if len(spec) and spec[0] is not None and arr.shape[0] % pc:
        raise ValueError(
            f"place_global: leading dim {arr.shape[0]} of a {tuple(spec)}-sharded array must "
            f"divide evenly over {pc} processes; pad the batch/instance axis or use a "
            f"replicated spec")
    return torch.from_numpy(np.ascontiguousarray(host_local_block(arr, spec)))


# ------------------------------------------------------------ collectives
def _summed(tensor: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``tensor`` summed over ``group``. A collective
    needs one shape on every rank, so a tensor without elements is empty on
    all of them and skips it alike."""
    out = tensor.clone(memory_format=torch.contiguous_format)
    if out.numel():
        dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the incoming gradients over
    the group: the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _summed(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce(tensor: torch.Tensor, differentiable: bool = False, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group`` (every rank by default): a new
    tensor, or ``tensor`` itself when the group is this rank alone."""
    if group_size(group) == 1:
        return tensor
    if differentiable:
        return _AllReduceSum.apply(tensor, group)
    return _summed(tensor, group)


# ------------------------------------------------------------ the model axis
# ``split`` below is a ``parallel.mesh.ModelSplit``: this rank's ``index``
# of the ``size`` ranks of the model ``group``.
class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model(x: torch.Tensor, split) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group: before a
    column layer, whose columns each see only their own part of the
    gradient of an input every rank holds whole."""
    return _ToModel.apply(x, split.group)


def from_model(x: torch.Tensor, split) -> torch.Tensor:
    """The sum of the group's partial products ``x`` (after a row layer);
    the gradient passes to each partial unchanged."""
    return _FromModel.apply(x, split.group)


def placed(block: torch.Tensor, dim: int, lo: int, total: int) -> torch.Tensor:
    """``block`` at [lo, lo + len) of a zero tensor ``total`` long on
    ``dim`` (its backward is the block's slice of the gradient)."""
    dim = dim % block.dim()
    hi = lo + block.shape[dim]
    zeros = list(block.shape)
    parts = []
    if lo:
        zeros[dim] = lo
        parts.append(block.new_zeros(zeros))
    parts.append(block)
    if total > hi:
        zeros[dim] = total - hi
        parts.append(block.new_zeros(zeros))
    return torch.cat(parts, dim) if len(parts) > 1 else block


def gather_from_model(x: torch.Tensor, split, dim: int = -1,
                      partial: bool = False) -> torch.Tensor:
    """Each rank's block of ``dim`` gathered into the whole (a sum into
    zeros). Backward: this rank's block of the gradient, which is whole on
    every rank when what consumes the gathered tensor runs replicated; with
    ``partial`` (the consumer is a column layer, each rank's gradient a part
    of the whole) the gradients are summed over the group first."""
    k = x.shape[dim]
    full = placed(x, dim, split.index * k, split.size * k)
    return _AllReduceSum.apply(full, split.group) if partial else from_model(full, split)


def scatter_to_model(x: torch.Tensor, split, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``dim`` of ``x``, which every rank of the group
    holds whole; backward, the blocks' gradients gathered."""
    k = x.shape[dim] // split.size
    return to_model(x, split).narrow(dim, split.index * k, k)


def barrier() -> None:
    """Wait for every rank (an all_reduce, the collective both backends run)."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=_wire_device(torch.device("cpu"))))


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``tensor`` replaced in place by rank ``src``'s."""
    if dist.is_initialized():
        dist.broadcast(tensor, src)
    return tensor


def from_rank0(fn):
    """``fn()`` run on rank 0 alone, its (picklable) result broadcast to
    every rank; ``fn()`` itself without a group. For inputs that must be the
    same on every rank but that each process would compute apart (LUMA's
    hashed text ids are salted per process). A failure on rank 0 is raised
    on every rank. The other ranks wait in the broadcast, so ``fn`` must end
    within the group's timeout."""
    if world_size() == 1:
        return fn()
    box = [None]
    if rank() == 0:
        try:
            box = [(True, fn())]
        except Exception as e:  # sent, so that no rank waits for the timeout
            box = [(False, e)]
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if ok:
        return value
    if rank() == 0:
        raise value
    raise RuntimeError(f"rank 0 failed: {value!r}") from value


def gather_rows(local: torch.Tensor, total: int, lo: int,
                differentiable: bool = False, group=None) -> torch.Tensor:
    """Every rank's block of rows gathered into the (total, ...) tensor on
    every rank of ``group`` (the mesh's data group), this rank's block at
    [lo, lo + len(local)): a sum into zeros."""
    hi = lo + local.shape[0]
    pad = (0, 0) * (local.dim() - 1)
    full = torch.nn.functional.pad(local, pad + (lo, total - hi))
    return all_reduce(full, differentiable, group)


def gather_instances(tree, total: int, sl: slice, group=None):
    """Each tensor leaf of ``tree`` holds this rank's block ``sl`` of
    ``total`` on its leading axis (stacked instances, or a request's rows):
    gathered to all ``total`` on every rank of ``group`` (the mesh's data
    group), in one collective (float64 on the wire, exact for every type
    used here). Leaves that are not tensors are returned as they are."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(tree)
    at = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]
    if not at:
        return tree
    wire = _wire_device(leaves[at[0]].device)
    blocks = []
    for i in at:
        t = leaves[i]
        full = torch.zeros((total, *t.shape[1:]), dtype=torch.float64, device=wire)
        full[sl] = t.detach().to(device=wire, dtype=torch.float64)
        blocks.append(full.reshape(-1))
    flat = all_reduce(torch.cat(blocks), group=group)
    offset = 0
    for i in at:
        t = leaves[i]
        n = total * int(np.prod(t.shape[1:], dtype=np.int64))
        leaves[i] = flat[offset:offset + n].reshape(total, *t.shape[1:]).to(
            device=t.device, dtype=t.dtype)
        offset += n
    return tree_unflatten(leaves, spec)


def _wire_device(device: torch.device) -> torch.device:
    """Where a collective's buffer lives: NCCL reduces only on the card."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


# ------------------------------------------------------------ the step's row split
class RowSplit(NamedTuple):
    """How one step's global batch of ``bounds[-1][1]`` rows is split over
    the mesh's data axis: rank i holds rows [bounds[i][0], bounds[i][1]).
    The terms that couple rows sum over ``group``, the ranks of this rank's
    model index (None: every rank)."""

    bounds: tuple  # ((lo, hi), ...) per data index
    index: int     # this rank's data index
    group: Any = None

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]

    @property
    def total(self) -> int:
        return self.bounds[-1][1]


_ROW_SPLIT: contextvars.ContextVar = contextvars.ContextVar("row_split", default=None)


@contextlib.contextmanager
def row_split(split: Optional[RowSplit]):
    """Within the block, terms that couple rows read ``split`` through
    :func:`current_row_split` and take their global form."""
    token = _ROW_SPLIT.set(split)
    try:
        yield split
    finally:
        _ROW_SPLIT.reset(token)


def current_row_split() -> Optional[RowSplit]:
    """The row split of the data-parallel step running now (None outside one)."""
    return _ROW_SPLIT.get()
