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


def fit_job(job: CellJob, data, n_train: int, batch_size: int) -> Dict[str, Any]:
    """Fit the job's S heads at once on ``data = (train, test)`` and evaluate
    them on the test split; every value stays on the device."""
    train_data, test_data = data
    task = job.tasks[0]
    res = train_many(
        model=task.model, params=stack_params([t.model for t in job.tasks]),
        loss_fn=task.loss_fn, data=train_data, n_train=n_train, optimizer=task.optimizer,
        epochs=job.epochs, batch_size=batch_size, randomness=job.randomness,
        val_fn=task.val_fn, val_data=test_data,
    )
    ev = evidences_many(task, res.params, test_data)
    metrics = tuple(
        _eval_all(ev[s], task.aggregation(ev[s]), test_data["y"][s], task.num_classes)
        for s in range(ev.shape[0])
    )
    return {"metrics": metrics, "params": res.params, "train_loss": res.train_loss,
            "val_loss": res.val_loss, "val_acc": res.val_acc, "final_lr": res.final_lr}


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
) -> Dict[str, Any]:
    """Run the whole cell for all seeds; every array input carries the S axis
    first. Returns, on the device, {"backbone_params", "backbone_train_loss",
    "jobs": {name: fit_job result}}."""
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

