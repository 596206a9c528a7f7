"""One-program sweep cell: a whole (dataset, condition) cell, all seeds, in
one call with one fetch.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/sweep_cell.py``
(``CellJob``, ``run_cell``, ``cell_rows``, lines 72-215; ``cell_rows`` is
:func:`job_rows` per head here). The JAX package
jits the cell into one XLA program. Here :func:`run_cell` issues the whole
cell on the device, S seeds at a time through the seed-batched trainer
(``core.train.train_many``):

    backbone fit -> frozen embeddings (train + test)
      -> every head fit (probes on embeddings, late fusion on raw views)
        -> every head's full evaluation (``eval.analysis._eval_all``)

and nothing comes back to the host until ``eval.analysis.fetch`` copies
the whole result (histories, validation metrics, plateau LRs, evaluation
metrics, trained parameters) in one transfer. The ``--vmap-seeds`` engine
runs the same :func:`fit_job` per head and fetches after each, so the two
engines give the same rows bit for bit. Capturing the steps as CUDA graphs,
the nearest analogue of the single XLA program, is later work
(``ROADMAP.md``).

``mesh`` (JAX lines 93-98, 177-187): the seed axis is split over the mesh's
``data`` axis, each rank running its S / n_dp seeds' fits and evaluations
with no collective inside them (the head kernel at (S / n_dp) x V heads),
and one gather gives every rank the results of all S seeds.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import torch

from ..eval.analysis import _eval_all, format_eval_result
from .tasks import embed_many, evidences_many
from .train import OptimizerConfig, stack_params, train_many


class CellJob(NamedTuple):
    """One head fit of the cell, for all S seeds."""

    name: str
    tasks: Sequence[Any]     # one EvidentialTask per seed; task s holds seed s's init
    randomness: Sequence[Any]  # each seed's fit draws
    kind: str                # 'probe' (embeddings) | 'raw' (views)
    epochs: int
    # Evaluation layout: the reference dispatches by model name, so late
    # fusion is evaluated with the [shared, views...] layout (its view 0
    # labelled "shared"), kept for column parity.
    shared_layout: bool


def fit_job(job: CellJob, data, n_train: int, batch_size: int,
            drop_last: bool = False, mesh: Any = None) -> Dict[str, Any]:
    """Fit the job's S heads at once on ``data = (train, test)`` and evaluate
    them on the test split; every value stays on the device. Under a
    ``mesh`` each rank fits and evaluates its seeds, then all S are
    gathered."""
    if mesh is not None:
        from ..parallel.distributed import gather_instances
        from ..parallel.mesh import instances_of, shard_instances

        s_count = len(job.tasks)
        sl = instances_of(s_count, mesh, "fit_job(mesh=...)", "seed count")
        local = fit_job(_seed_block(job, sl), shard_instances(data, mesh, s_count), n_train,
                        batch_size, drop_last)
        return _unstack_metrics(gather_instances(_stack_metrics(local), s_count, sl,
                                                  mesh.data_group), s_count)
    train_data, test_data = data
    task = job.tasks[0]
    res = train_many(
        model=task.model, params=stack_params([t.model for t in job.tasks]),
        loss_fn=task.loss_fn, data=train_data, n_train=n_train, optimizer=task.optimizer,
        epochs=job.epochs, batch_size=batch_size, randomness=job.randomness,
        val_fn=task.val_fn, val_data=test_data, drop_last=drop_last,
    )
    ev = evidences_many(task, res.params, test_data)
    metrics = tuple(
        _eval_all(ev[s], task.aggregation(ev[s]), test_data["y"][s], task.num_classes)
        for s in range(ev.shape[0])
    )
    return {"metrics": metrics, "params": res.params, "train_loss": res.train_loss,
            "val_loss": res.val_loss, "val_acc": res.val_acc, "final_lr": res.final_lr}


def _seed_block(job: CellJob, sl: slice) -> CellJob:
    """The job cut to the seeds ``sl``."""
    return job._replace(tasks=job.tasks[sl], randomness=job.randomness[sl])


def _stack_metrics(result: Dict[str, Any]) -> Dict[str, Any]:
    """A :func:`fit_job` result with its per-seed ``metrics`` stacked on a
    leading seed axis (for a gather), and back with :func:`_unstack_metrics`."""
    from torch.utils._pytree import tree_map

    return {**result, "metrics": tree_map(lambda *xs: torch.stack(xs), *result["metrics"])}


def _unstack_metrics(result: Dict[str, Any], s_count: int) -> Dict[str, Any]:
    from torch.utils._pytree import tree_map

    stacked = result["metrics"]
    return {**result, "metrics": tuple(tree_map(lambda x, s=s: x[s], stacked)
                                       for s in range(s_count))}


def job_rows(job: CellJob, fetched: Dict[str, Any], seeds: Sequence[int]) -> Dict[int, dict]:
    """A fetched :func:`fit_job` result as {seed: nested metrics dict}, the
    schema of ``eval.analysis.evaluate_subjective_model[_with_shared]``."""
    views = fetched["metrics"][0]["blocks"]["accuracy"].shape[0]
    return {int(seed): format_eval_result(fetched["metrics"][s], views, job.shared_layout)
            for s, seed in enumerate(seeds)}


def head_data(embed_tr, embed_te, xs_tr, xs_te, y_tr, y_te) -> Dict[str, tuple]:
    """(train, test) data of each head kind: 'probe' on the frozen
    embeddings ``embed = (zc, zp)``, 'raw' on the views."""
    (zc_tr, zp_tr), (zc_te, zp_te) = embed_tr, embed_te
    return {
        "probe": ({"zc": zc_tr, "zp": zp_tr, "y": y_tr}, {"zc": zc_te, "zp": zp_te, "y": y_te}),
        "raw": ({"xs": xs_tr, "y": y_tr}, {"xs": xs_te, "y": y_te}),
    }


def run_cell(
    *,
    backbone: torch.nn.Module,
    bb_params: Dict[str, torch.Tensor],
    bb_loss_fn,
    bb_optimizer: OptimizerConfig,
    bb_epochs: int,
    bb_randomness: Sequence[Any],
    jobs: Sequence[CellJob],
    xs_tr,
    xs_te,
    y_tr: torch.Tensor,
    y_te: torch.Tensor,
    n_train: int,
    batch_size: int,
    mesh: Any = None,
) -> Dict[str, Any]:
    """Run the whole cell for all seeds; every array input carries the S axis
    first. Returns, on the device, {"backbone_params", "backbone_train_loss",
    "jobs": {name: fit_job result}}. Under a ``mesh`` each rank runs the
    whole cell for its seeds, and one gather at its end gives every rank
    all S."""
    if mesh is not None:
        from ..parallel.distributed import gather_instances
        from ..parallel.mesh import instances_of, shard_instances

        s_count = len(bb_randomness)
        sl = instances_of(s_count, mesh, "one-program cell (mesh=...)", "seed count")
        local = run_cell(
            backbone=backbone, bb_params=shard_instances(bb_params, mesh, s_count),
            bb_loss_fn=bb_loss_fn, bb_optimizer=bb_optimizer, bb_epochs=bb_epochs,
            bb_randomness=bb_randomness[sl], jobs=[_seed_block(j, sl) for j in jobs],
            xs_tr=shard_instances(xs_tr, mesh, s_count), xs_te=shard_instances(xs_te, mesh, s_count),
            y_tr=y_tr[sl], y_te=y_te[sl], n_train=n_train, batch_size=batch_size)
        local["jobs"] = {k: _stack_metrics(v) for k, v in local["jobs"].items()}
        full = gather_instances(local, s_count, sl, mesh.data_group)
        full["jobs"] = {k: _unstack_metrics(v, s_count) for k, v in full["jobs"].items()}
        return full
    bb = train_many(model=backbone, params=bb_params, loss_fn=bb_loss_fn, data={"xs": xs_tr},
                    n_train=n_train, optimizer=bb_optimizer, epochs=bb_epochs,
                    batch_size=batch_size, randomness=bb_randomness)
    data = head_data(embed_many(backbone, bb.params, xs_tr),
                     embed_many(backbone, bb.params, xs_te), xs_tr, xs_te, y_tr, y_te)
    return {
        "backbone_params": bb.params,
        "backbone_train_loss": bb.train_loss,
        "jobs": {job.name: fit_job(job, data[job.kind], n_train, batch_size) for job in jobs},
    }

