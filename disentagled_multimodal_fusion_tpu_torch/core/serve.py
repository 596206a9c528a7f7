"""Inference path: raw views in, predictions and Dirichlet uncertainty out.

Counterpart of ``build_inference_fn``, ``ServingEngine``,
``export_inference`` and ``load_exported`` of
``disentagled_multimodal_fusion_tpu/core/serve.py``, with the same six
output keys. The frozen backbone's ``get_embedding`` and the evidential
head run back to back on the task's device (:class:`InferenceModule`); the
head's forward is the evidential head kernel (``ops/cuda_kernels.py``, the
operator ``dmf::evidential_heads``) on the card.

The engine pads each request up to a static batch bucket with copies of
row 0 and slices the padding off after the call, in numpy. Every served
model is row-independent in eval mode, so padding never changes a real row.

``export_inference`` writes a ``torch.export`` artifact (``.pt2``) of the
inference module at one static batch, the weights inside: one per serving
bucket, as the JAX package writes one ``.stablehlo`` per bucket. Its graph
holds the head kernel as one call of ``dmf::evidential_heads``, not a
decomposition, so the artifact replays in a process that has torch and the
operator's standalone file ``ops/head_op.py`` (with the built kernel
library for a CUDA artifact; see that file), and not this package. Make
and load an artifact with the same torch version: the format is not
promised across versions (2.13 and 2.11, the two the port runs on). The
JAX package's ``platforms`` (a cross-export) has no counterpart: a CUDA
artifact is made on the card.

On the card the inference function replays a CUDA graph of the module, one
per input shape (:class:`CudaGraphs`): the first call at a shape on a
thread runs the module as it is (and warms up what a capture needs: cuBLAS,
cuDNN, the jiterator's digamma), the second captures it and replays, every
later call copies its views into the graph's inputs, replays and clones the
outputs.
The host then makes a few launches a request where the module makes
about thirty, and the card runs the same kernels back to back. The graphs
engage where every view is on a CUDA device, the module and all its
submodules are in eval mode, and no stream capture is already open on the
thread (the function always runs under inference mode); otherwise the
module runs as it is: on the CPU, in training mode, and in
``torch.export``, which traces the module and not the function. A graph
reads the weights where they were at its capture: a served model's
parameters are updated in place (``load_state_dict``), never given new
storage, while its function lives.

Spans (``core/logging.py``; recorded only inside ``logging.recording()``):
``serve.infer`` is the inference function's call, ``_as_tensor`` included,
and opens a request; inside it ``serve.replay`` holds a graph's copy-in,
replay and clone, and ``InferenceModule.forward`` holds ``serve.backbone``
(``get_embedding`` and the stack of the private embeddings),
``serve.heads`` (the task's evidence: the head operator's dispatch and
launch) and ``serve.uncertainty`` (aggregation, the Dirichlet
uncertainties, argmax and probs). On the card the module's three spans open
only where it runs eagerly or is captured, not at a replay. Each call adds
one to one counter: ``serve.eager_calls``, ``serve.graph_captures`` or
``serve.graph_replays``. ``serve.to_host`` is a root of its own with the
last request's id and the copies and bytes it brought back.

The mesh's ``data`` axis (JAX lines 103-172, 198-210): ``build_inference_fn(
mesh=)`` runs every rank of the mesh on the same request, each on its rows
of it, then gathers the outputs so that every rank returns the whole
batch; ``ServingEngine(divisor=n_dp)`` rounds every bucket up to a multiple
of the ``data`` axis so that each rank gets an equal part. Its ``module``
is the single-device program, so ``export_inference`` of a mesh-built
function exports that, as the JAX package unwraps ``jit_fn``. The HTTP
front and the daemon stay single-process, as in the JAX package.
"""

from __future__ import annotations

import collections
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.dirichlet import dirichlet_uncertainties
from .logging import count, held_counts, span

__all__ = ["build_inference_fn", "InferenceModule", "ServingEngine", "DEFAULT_BUCKETS",
           "to_host", "export_inference", "load_exported", "HEAD_OP", "CudaGraphs",
           "GRAPH_SHAPES"]

# the head kernel's operator, as an exported graph names it
HEAD_OP = "dmf.evidential_heads"

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# the most input shapes an inference function keeps a CUDA graph of (and
# the most it remembers having seen once): every default bucket, and room
GRAPH_SHAPES = 16


def to_host(out: dict) -> dict:
    """The output dict with every tensor copied to a numpy array."""
    with span("serve.to_host") as s:
        host = {
            k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()
        }
        if s is not None:
            s.attrs.update(copies=sum(isinstance(v, torch.Tensor) for v in out.values()),
                           bytes=sum(a.nbytes for a in host.values()))
    return host


class InferenceModule(nn.Module):
    """Raw views to predictions and uncertainties, as one module: the
    backbone's ``get_embedding`` (when there is one), the task's evidence,
    its aggregation and the six outputs. ``forward(xs)`` takes the tuple of
    per-view (B, S_i) tensors, float32, or int64 token ids for a text
    tower. The task's model and the backbone are its submodules, so their
    weights are its own (and an exported program's)."""

    def __init__(self, task, backbone=None):
        super().__init__()
        self.model = task.model
        self.backbone = backbone
        self.evidences_fn = task.evidences_fn
        self.aggregation = task.aggregation
        self.num_classes = task.num_classes
        # an inference program; its submodules keep the mode their owners set
        self.training = False

    def forward(self, xs):
        with span("serve.backbone"):
            if self.backbone is not None:
                zc, zp_list = self.backbone.get_embedding(xs)
                data = {"zc": zc, "zp": torch.stack(zp_list, dim=1)}
            else:
                data = {"xs": tuple(xs)}
        with span("serve.heads"):
            ev = self.evidences_fn(data)
        with span("serve.uncertainty"):
            fused = self.aggregation(ev)
            alpha = fused.float() + 1.0
            epistemic, aleatoric = dirichlet_uncertainties(fused, self.num_classes)
            return {
                "pred": torch.argmax(fused, dim=-1),
                "probs": alpha / torch.sum(alpha, dim=-1, keepdim=True),
                "evidence": ev,
                "fused_evidence": fused,
                "epistemic": epistemic,
                "aleatoric": aleatoric,
            }


def _as_tensor(x, device) -> torch.Tensor:
    """A view as a tensor on ``device``: integer views (token ids) as int64,
    every other view as float32."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        integer = np.issubdtype(x.dtype, np.integer)
        x = torch.from_numpy(np.array(x, dtype=np.int64 if integer else np.float32))
    integer = not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)
    return x.to(device=device, dtype=torch.int64 if integer else torch.float32)


def graph_key(xs) -> tuple:
    """The key of a call's CUDA graph: each view's shape and dtype, and the
    device."""
    return tuple((tuple(x.shape), x.dtype) for x in xs) + (xs[0].device,)


class _Graph:
    """One capture of a module at one input key: static inputs, the graph,
    its outputs packed into one flat byte buffer (the widest types first, so
    each output's view of it is aligned), and the counts the capture held
    (each replay adds them)."""

    def __init__(self, module, xs, stream):
        self.inputs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                            for x in xs)
        torch._foreach_copy_(self.inputs, xs)
        self.graph = torch.cuda.CUDAGraph()
        with held_counts() as self.counts, torch.cuda.graph(
                self.graph, stream=stream, capture_error_mode="thread_local"):
            out = module(self.inputs)
            packed = sorted(out, key=lambda name: -out[name].element_size())
            self.out = torch.cat([out[name].reshape(-1).view(torch.uint8) for name in packed])
        at, offset = {}, 0
        for name in packed:
            t = out[name]
            at[name] = (offset, offset + t.numel() * t.element_size(), t.dtype, t.shape)
            offset = at[name][1]
        self.layout = [(name, *at[name]) for name in out]

    def __call__(self, xs) -> dict:
        with span("serve.replay"):
            torch._foreach_copy_(self.inputs, xs)
            self.graph.replay()
            for name, n in self.counts.items():
                count(name, n)
            out = self.out.clone()
            return {name: out[a:b].view(dtype).view(shape)
                    for name, a, b, dtype, shape in self.layout}


class CudaGraphs:
    """Runs a module through CUDA graphs, one per input key (:func:`graph_key`),
    where that is safe, else as it is.

    The first call at a key on a thread runs the module (the capture's
    warm-up: a thread's first call makes its cuBLAS and cuDNN handles, which
    a capture cannot), the second on that thread captures it on a side
    stream and replays; later calls replay, on any thread.
    Every call returns tensors of its own: a replay's outputs are cloned
    out of the graph's (one device copy). At most ``GRAPH_SHAPES`` graphs
    are kept, and as many keys seen once on a thread; the least recently
    used go first, and a graph's memory pool goes with it. Calls on several
    threads are safe: a lock holds each capture, and each copy-in, replay
    and clone, together.

    :meth:`step` is the bookkeeping alone (no card needed): what a call at
    a key does, ``"eager"``, ``"capture"`` or ``"replay"``; :meth:`keep`
    stores a captured graph."""

    def __init__(self, module):
        self.module = module
        self.graphs = collections.OrderedDict()
        self.seen = collections.OrderedDict()
        self.lock = threading.Lock()
        self.stream = None
        self._modules = list(module.modules())

    def engages(self, xs) -> bool:
        """Whether a call on ``xs`` (tensors) goes through a graph: every
        view on a CUDA device, every module in eval mode, no capture open on
        the current stream."""
        return (all(x.is_cuda for x in xs) and not any(m.training for m in self._modules)
                and not torch.cuda.is_current_stream_capturing())

    def step(self, key) -> str:
        if key in self.graphs:
            self.graphs.move_to_end(key)
            return "replay"
        mine = (key, threading.get_ident())
        if mine in self.seen:
            del self.seen[mine]
            return "capture"
        self.seen[mine] = None
        if len(self.seen) > GRAPH_SHAPES:
            self.seen.popitem(last=False)
        return "eager"

    def keep(self, key, graph) -> None:
        self.graphs[key] = graph
        if len(self.graphs) > GRAPH_SHAPES:
            self.graphs.popitem(last=False)

    def __call__(self, xs) -> dict:
        if not self.engages(xs):
            count("serve.eager_calls")
            return self.module(xs)
        key = graph_key(xs)
        with self.lock:
            what = self.step(key)
            if what == "replay":
                count("serve.graph_replays")
                return self.graphs[key](xs)
            if what == "capture":
                count("serve.graph_captures")
                if self.stream is None:
                    self.stream = torch.cuda.Stream(xs[0].device)
                graph = _Graph(self.module, xs, self.stream)
                self.keep(key, graph)
                return graph(xs)
        count("serve.eager_calls")
        return self.module(xs)


def build_inference_fn(task, *, backbone=None, mesh=None):
    """``fn(xs) -> dict`` from raw views to predictions and uncertainties.

    task
        A :class:`~.tasks.EvidentialTask`; its model's device is where the
        function runs.
    backbone
        When given, the frozen backbone's ``get_embedding`` turns the views
        into (zc, zp) for a probe; otherwise the task takes the views
        themselves (late fusion).

    ``xs`` are per-view (B, S_i) arrays or tensors (an integer view, a text
    tower's token ids, stays integer: int64). The outputs are tensors
    on the task's device: ``pred`` (B,), ``probs`` (B, C) the Dirichlet mean
    alpha/S, ``evidence`` (B, V, C) per view, ``fused_evidence`` (B, C),
    ``epistemic`` (B,) = K/S and ``aleatoric`` (B,), each the caller's own
    (a later call does not overwrite them). The function runs ``fn.module``,
    an :class:`InferenceModule`, under inference mode, on the card through
    its CUDA graphs (``fn.graphs``, a :class:`CudaGraphs`; deleting the
    function frees them); :func:`export_inference` exports that module.

    mesh
        A ``parallel.mesh.Mesh``: every rank calls ``fn`` with the same
        request, runs the module on its rows (``B / n_dp``; B must divide by
        the ``data`` axis, which ``ServingEngine(divisor=)`` ensures) and
        gathers the outputs of all rows in one collective over its data
        group. The weights are each rank's own copy, whole and the same on
        every rank: a mesh with a ``model`` axis serves them whole, as the
        JAX package replicates them, its model group's ranks repeating one
        another's rows. Each rank runs its rows through its own graphs; the
        gather runs outside them.
    """
    module = InferenceModule(task, backbone)
    device = next(task.model.parameters()).device
    graphs = CudaGraphs(module)

    @torch.inference_mode()
    def infer(xs: Sequence):
        with span("serve.infer", new_request=True):
            return graphs(tuple(_as_tensor(x, device) for x in xs))

    infer.module, infer.graphs = module, graphs
    if mesh is None:
        return infer

    from ..parallel.distributed import gather_instances
    from ..parallel.mesh import rows_of

    n_dp = mesh.shape["data"]

    def infer_rows(xs: Sequence):
        rows = len(xs[0])
        if rows % n_dp:
            raise ValueError(f"a batch of {rows} rows does not divide over the mesh's 'data' "
                             f"axis ({n_dp}); pass divisor={n_dp} to ServingEngine")
        sl = rows_of(rows, mesh)
        out = infer(tuple(x[sl] for x in xs))
        with torch.inference_mode():
            return gather_instances(out, rows, sl, mesh.data_group)

    infer_rows.module = module
    return infer_rows


class ServingEngine:
    """Static-shape batch buckets around an inference fn.

    Each request is rounded up to the next bucket (padding with copies of
    row 0), run, and sliced back; requests larger than the top bucket run
    at the next multiple of it. Returns numpy arrays.
    """

    def __init__(self, infer_fn, buckets: Sequence[int] = DEFAULT_BUCKETS, divisor: int = 1):
        """``divisor``: round every bucket up to a multiple of it; set it to
        the mesh's ``data`` axis when the inference fn splits rows over a
        mesh, so each rank gets an equal part."""
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        if divisor <= 0:
            raise ValueError(f"divisor must be positive: {divisor}")
        self.infer_fn = infer_fn
        self.divisor = int(divisor)
        self.buckets = tuple(
            sorted(set(-(-int(b) // self.divisor) * self.divisor for b in buckets)))

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    def warmup(self, xs_sample: Sequence, buckets=None) -> None:
        """Run the given buckets (all by default) once each, from one row."""
        row = tuple(np.asarray(x)[:1] for x in xs_sample)
        for b in buckets or self.buckets:
            to_host(self.infer_fn(tuple(np.broadcast_to(x, (b, *x.shape[1:])) for x in row)))

    def __call__(self, xs: Sequence):
        xs = tuple(np.asarray(x) for x in xs)
        n = xs[0].shape[0]
        if n == 0:
            raise ValueError("empty batch")
        b = self.bucket_for(n)
        if b != n:
            xs = tuple(
                np.concatenate([x, np.broadcast_to(x[:1], (b - n, *x.shape[1:]))], axis=0)
                for x in xs
            )
        out = to_host(self.infer_fn(xs))
        if b != n:
            out = {k: v[:n] for k, v in out.items()}
        return out


def export_inference(infer_fn, xs_example: Sequence, path=None):
    """Export the inference program, weights inside, with ``torch.export``.

    ``infer_fn`` is a :func:`build_inference_fn` function (its ``module``
    is exported); ``xs_example`` fixes the artifact's static batch shape,
    so export one per serving bucket. Returns the
    ``torch.export.ExportedProgram``; with ``path`` it also writes the
    ``.pt2`` there, its weights saved frozen (no gradient). The graph must
    hold exactly one call of the head kernel's operator (``HEAD_OP``), else
    this raises: every served model's heads go through the kernel, and an
    artifact that decomposed them would not be the program that is served.
    A module holding a text tower (``models/text_tower.py``; its
    ``exportable`` is False) raises ``NotImplementedError``.
    """
    module = infer_fn.module
    refused = [type(m).__name__ for m in module.modules()
               if getattr(m, "exportable", True) is False]
    if refused:
        raise NotImplementedError(f"export_inference: {', '.join(sorted(set(refused)))} cannot "
                                  f"be exported (its expert kernel is a ctypes launch, not an "
                                  f"operator that torch.export traces); serve it through "
                                  f"build_inference_fn")
    device = next(module.parameters()).device
    xs = tuple(_as_tensor(x, device) for x in xs_example)
    grads = [(p, p.requires_grad) for p in module.parameters()]
    try:
        # the weights are constants of a served program; a parameter that
        # wants a gradient would also trip the head kernel's no-backward guard
        for p, _ in grads:
            p.requires_grad_(False)
        exported = torch.export.export(module, (xs,), strict=False)
        calls = head_op_calls(exported)
        if calls != 1:
            raise RuntimeError(f"the exported graph holds {calls} calls of {HEAD_OP}, "
                               f"expected 1")
        if path is not None:
            torch.export.save(exported, str(path))
    finally:
        for p, flag in grads:
            p.requires_grad_(flag)
    return exported


def head_op_calls(exported) -> int:
    """How many nodes of an exported program's graph call the head kernel's
    operator."""
    return sum(1 for node in exported.graph.nodes
               if node.op == "call_function" and str(node.target).startswith(HEAD_OP))


def load_exported(path):
    """Load an :func:`export_inference` artifact into a callable.

    Needs no model code, config or checkpoint: the program and its weights
    are in the file (the head kernel's operator must be registered, as it
    is once this package, or ``ops/head_op.py`` alone, is imported). The
    callable takes the views tuple at the exported batch shape (arrays or
    tensors) and returns the output dict, without gradients; wrap it in a
    :class:`ServingEngine` for dynamic batches.
    """
    program = torch.export.load(str(Path(path))).module()
    device = next(iter(program.state_dict().values())).device

    @torch.inference_mode()
    def call(xs: Sequence):
        return program(tuple(_as_tensor(x, device) for x in xs))

    return call
