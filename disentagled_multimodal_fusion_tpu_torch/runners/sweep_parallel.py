"""Dataset-parallel UQ-sweep orchestrator.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/sweep_parallel.py``.
Every (dataset, condition) cell of the UQ sweep is independent; this runner
round-robins the dataset list over N worker processes, each running the
ordinary ``runners.run`` sweep of the port on its datasets with its own
``--rows-file`` and ``--skip-report``, then merges the rows and writes the
one combined three-sheet report through the same ``write_sweep_report`` the
in-process sweep uses.

Device placement is per worker through ``--worker-env`` (``{rank}`` and
``{nranks}`` are substituted), so on a machine with several cards each
worker can own one:

    python -m disentagled_multimodal_fusion_tpu_torch.runners.sweep_parallel \\
        --procs 4 --worker-env CUDA_VISIBLE_DEVICES={rank}

There is no default device environment: a worker runs where ``runners.run``
runs, the card unless ``--device cpu`` is passed through, and a worker
without a card fails loudly. Workers that exit non-zero are run again up to
``--max-retries`` times; the rows-file resume makes a retry skip the cells
already done. Unrecognised flags pass through to every worker as they are
(``--quick``, ``--dtype``, ``--vmap-seeds``, ``--device``, ...).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from ..core.artifacts import artifact_path

RUN_MODULE = "disentagled_multimodal_fusion_tpu_torch.runners.run"


def partition(items, n):
    """Round-robin split preserving order within each part."""
    parts = [items[i::n] for i in range(n)]
    return [p for p in parts if p]


def _expand_env(pairs, rank, nranks):
    env = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--worker-env needs KEY=VAL, got {p!r}")
        k, v = p.split("=", 1)
        env[k] = v.format(rank=rank, nranks=nranks)
    return env


class Worker:
    """One worker process of the sweep, with its datasets, rows file and log."""

    def __init__(self, rank, datasets, args, passthrough, logs_dir):
        self.rank = rank
        self.datasets = datasets
        self.rows_file = str(artifact_path(args.rows_dir) / f"sweep_rows_w{rank}.json")
        self.log_path = logs_dir / f"sweep_worker_{rank}.log"
        self.attempts = 0
        self.proc = None
        self._log_f = None
        self.env = _expand_env(args.worker_env, rank, args.procs)
        self.cmd = [
            sys.executable, "-u", "-m", RUN_MODULE,
            "--datasets", *datasets,
            "--rows-file", self.rows_file, "--skip-report",
            *(["--seeds", *map(str, args.seeds)] if args.seeds is not None else []),
            *(["--conditions", *args.conditions] if args.conditions else []),
            *passthrough,
        ]

    def launch(self):
        self.attempts += 1
        self._log_f = open(self.log_path, "a")
        self._log_f.write(f"\n=== attempt {self.attempts}: {' '.join(self.cmd)} ===\n")
        self._log_f.flush()
        self.proc = subprocess.Popen(self.cmd, stdout=self._log_f, stderr=subprocess.STDOUT,
                                     env={**os.environ, **self.env})
        print(f"[w{self.rank}] attempt {self.attempts} pid {self.proc.pid} "
              f"datasets={self.datasets} env={self.env}", flush=True)

    def poll(self):
        rc = self.proc.poll()
        if rc is not None and self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        return rc


def merge_rows(paths):
    """Merge per-worker nested rows {seed: {cond: {ds: {model: row}}}}.

    Dataset partitions are disjoint, so a same-(seed, cond) collision can
    only be dataset-level; later workers must not clobber earlier ones.
    """
    rows = {}
    for p in paths:
        if not Path(p).exists():
            # a worker can exit 0 with nothing to do (e.g. a condition
            # filter matching no cells): warn rather than fail the merge
            print(f"warning: no rows file at {p}; skipping", file=sys.stderr)
            continue
        saved = json.loads(Path(p).read_text())
        for s, conds in saved.items():
            seed_rows = rows.setdefault(int(s), {})
            for cond, ds_map in conds.items():
                seed_rows.setdefault(cond, {}).update(ds_map)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--procs", type=int, default=4,
                        help="worker process count (datasets are round-robined)")
    parser.add_argument("--datasets", type=str, nargs="*", default=None)
    parser.add_argument("--seeds", type=int, nargs="*", default=None)
    parser.add_argument("--conditions", type=str, nargs="*", default=["Normal", "Conflict"])
    parser.add_argument("--worker-env", action="append", default=[], metavar="KEY=VAL",
                        help="env var for each worker; {rank}/{nranks} are substituted "
                             "(repeatable), e.g. CUDA_VISIBLE_DEVICES={rank}")
    parser.add_argument("--max-retries", type=int, default=3,
                        help="re-invocations per worker after a non-zero exit (the rows-file "
                             "resume skips completed cells)")
    parser.add_argument("--rows-dir", default="logs", help="directory for per-worker rows files")
    args, passthrough = parser.parse_known_args(argv)

    from .common import load_config, make_getter

    C = make_getter(load_config("config.yaml"))
    datasets = args.datasets or C("experiment.normal_datasets",
                                  ["CUB", "HandWritten", "PIE", "Scene"])
    logs_dir = artifact_path("logs")
    logs_dir.mkdir(parents=True, exist_ok=True)
    artifact_path(args.rows_dir).mkdir(parents=True, exist_ok=True)

    parts = partition(datasets, args.procs)
    workers = [Worker(r, part, args, passthrough, logs_dir) for r, part in enumerate(parts)]

    # a plain `kill` (SIGTERM) must run the worker clean-up below, not leave
    # the workers running
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    t0 = time.time()
    failed = []
    pending = list(workers)
    try:
        for w in workers:
            w.launch()
        while pending:
            time.sleep(0.5)
            for w in list(pending):
                rc = w.poll()
                if rc is None:
                    continue
                if rc == 0:
                    print(f"[w{w.rank}] done in {time.time() - t0:.1f}s", flush=True)
                    pending.remove(w)
                elif w.attempts <= args.max_retries:
                    print(f"[w{w.rank}] exit {rc}; retrying ({w.attempts}/{args.max_retries} "
                          f"used); see {w.log_path}", flush=True)
                    w.launch()
                else:
                    print(f"[w{w.rank}] exit {rc}; retries exhausted; see {w.log_path}",
                          flush=True)
                    failed.append(w)
                    pending.remove(w)
    except BaseException:
        # no orphaned workers when the orchestrator dies (Ctrl-C, a failure):
        # the cells done so far are in the per-worker rows files
        for w in pending:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
                w.proc.wait()
                print(f"[w{w.rank}] terminated (orchestrator exiting); resume later with the "
                      f"same command", flush=True)
        raise

    if failed:
        for w in failed:
            tail = Path(w.log_path).read_text().splitlines()[-15:]
            print(f"--- w{w.rank} log tail ---\n" + "\n".join(tail), file=sys.stderr)
        raise SystemExit(f"{len(failed)} worker(s) failed; completed cells are preserved in "
                         f"their rows files; run the same command again to resume")

    rows = merge_rows([w.rows_file for w in workers])
    from .run import write_sweep_report

    table = write_sweep_report(
        rows, C("logging.datasets_excel_path", "logs/dataset_analysis.xlsx"))
    print(f"parallel sweep ({len(workers)} workers, {len(datasets)} datasets) done in "
          f"{time.time() - t0:.1f}s", flush=True)
    return table


if __name__ == "__main__":
    main()
