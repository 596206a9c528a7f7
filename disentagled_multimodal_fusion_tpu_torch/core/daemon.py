"""Serving daemon: a micro-batching request front over :class:`ServingEngine`.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/daemon.py``:

- concurrent clients submit requests of any row count and get a
  :class:`concurrent.futures.Future` back (or block via :meth:`infer`);
- one dispatcher thread coalesces queued requests into one engine call;
- the flush deadline bounds the wait: the batch launches once the oldest
  request has waited ``max_delay_ms``, or earlier once the queued rows fill
  the bucket the batch would round up to anyway;
- results are sliced back row-exactly, so clients never see the batching.

One dispatcher talks to the device: throughput comes from larger batches.
Futures are resolved outside the daemon's lock, so a done-callback may call
back into the daemon.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from .serve import to_host

__all__ = ["ServingDaemon", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Raised by submit() when the queue holds max_queue_rows rows; the
    backpressure signal (the HTTP front maps it to 503)."""


class _Request:
    __slots__ = ("xs", "n", "future", "t_in")

    def __init__(self, xs, n):
        self.xs = xs
        self.n = n
        self.future: Future = Future()
        self.t_in = time.perf_counter()


class ServingDaemon:
    """Micro-batching dispatcher over a :class:`~.serve.ServingEngine`.

    engine
        A ``ServingEngine``, or any callable from a views tuple to a dict of
        arrays with a leading row axis (``bucket_for`` enables the early
        flush; without it only the deadline applies).
    max_delay_ms
        Flush deadline for the oldest queued request.
    max_batch
        Most rows coalesced into one call (default: the engine's top bucket,
        else 1024).
    max_queue_rows
        submit() raises :class:`QueueFullError` once this many rows wait
        (default 64 x max_batch).
    """

    def __init__(self, engine, max_delay_ms: float = 2.0,
                 max_batch: Optional[int] = None,
                 max_queue_rows: Optional[int] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0: {max_delay_ms}")
        self.engine = engine
        self.max_delay = max_delay_ms / 1e3
        buckets = getattr(engine, "buckets", None)
        if max_batch is None:
            max_batch = max(buckets) if buckets else 1024
        self.max_batch = int(max_batch)
        if self.max_batch <= 0:
            raise ValueError(f"max_batch must be positive: {self.max_batch}")
        self.max_queue_rows = int(
            64 * self.max_batch if max_queue_rows is None else max_queue_rows
        )
        if self.max_queue_rows <= 0:
            raise ValueError(f"max_queue_rows must be positive: {self.max_queue_rows}")
        self._queue: deque = deque()
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._n_requests = 0
        self._n_batches = 0
        self._n_rows = 0
        self._latencies: deque = deque(maxlen=100_000)
        self._thread = threading.Thread(target=self._loop, name="serving-daemon", daemon=True)
        self._thread.start()

    # ---- client side ----------------------------------------------------

    def submit(self, xs: Sequence) -> Future:
        """Enqueue one request (per-view arrays with a shared row axis);
        the Future resolves to the engine's output for exactly its rows."""
        xs = tuple(np.asarray(x) for x in xs)
        n = int(xs[0].shape[0])
        if n == 0:
            raise ValueError("empty batch")
        if any(int(x.shape[0]) != n for x in xs):
            raise ValueError(f"views disagree on rows: {[int(x.shape[0]) for x in xs]}")
        req = _Request(xs, n)
        with self._wake:
            if self._closed:
                raise RuntimeError("daemon is closed")
            if self._queued_rows >= self.max_queue_rows:
                raise QueueFullError(
                    f"queue at {self._queued_rows} rows "
                    f"(max_queue_rows={self.max_queue_rows}); retry later"
                )
            self._queue.append(req)
            self._queued_rows += n
            self._wake.notify()
        return req.future

    def infer(self, xs: Sequence):
        """Blocking convenience: submit + wait."""
        return self.submit(xs).result()

    # ---- dispatcher -----------------------------------------------------

    def _take_batch(self):
        """Block until a batch is due, then drain it; [] once closed and empty.

        A batch never exceeds ``max_batch`` (a larger total would round to a
        bucket the engine never warmed up), except that a single request
        larger than ``max_batch`` goes alone.
        """
        bucket_for = getattr(self.engine, "bucket_for", None)
        with self._wake:
            while True:
                if self._closed and not self._queue:
                    return []
                if not self._queue:
                    self._wake.wait()
                    continue
                rows = self._queued_rows
                full = rows >= self.max_batch or (
                    bucket_for is not None and rows == bucket_for(rows)
                )
                timeout = self._queue[0].t_in + self.max_delay - time.perf_counter()
                if full or timeout <= 0 or self._closed:
                    batch, taken = [], 0
                    while self._queue and (
                        taken == 0 or taken + self._queue[0].n <= self.max_batch
                    ):
                        batch.append(self._queue.popleft())
                        taken += batch[-1].n
                    self._queued_rows -= taken
                    return batch
                self._wake.wait(timeout)

    def _loop(self):
        try:
            self._loop_inner()
        finally:
            # A dead dispatcher refuses further submits and fails whatever is
            # still queued, so no client waits forever.
            with self._wake:
                self._closed = True
                dead = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
            for r in dead:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(RuntimeError("serving daemon dispatcher exited"))

    def _loop_inner(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            # RUNNING first: a cancelled Future would raise on set_result and
            # kill this thread; riders whose client cancelled are dropped.
            batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                xs = tuple(
                    np.concatenate([r.xs[v] for r in batch], axis=0)
                    for v in range(len(batch[0].xs))
                ) if len(batch) > 1 else batch[0].xs
                out = to_host(self.engine(xs))
            except BaseException as e:  # an engine failure fails every rider
                for r in batch:
                    r.future.set_exception(e)
                if not isinstance(e, Exception):
                    raise
                continue
            t_done = time.perf_counter()
            slices, off = [], 0
            for r in batch:
                slices.append({k: v[off:off + r.n] for k, v in out.items()})
                off += r.n
            with self._lock:
                self._latencies.extend(t_done - r.t_in for r in batch)
                self._n_requests += len(batch)
                self._n_batches += 1
                self._n_rows += off
            for r, sl in zip(batch, slices):
                r.future.set_result(sl)

    # ---- lifecycle / observability --------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lats = sorted(self._latencies)
            n_req, n_batch, n_rows = self._n_requests, self._n_batches, self._n_rows
            queued = self._queued_rows

        def pct(p):
            return round(lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3, 3) if lats else None

        return {
            "requests": n_req,
            "batches": n_batch,
            "rows": n_rows,
            "mean_batch_rows": round(n_rows / max(1, n_batch), 2),
            "queued_rows": queued,
            "latency_ms": {"p50": pct(0.5), "p95": pct(0.95), "p99": pct(0.99)},
        }

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue and stop the dispatcher; later submits raise."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
