"""Per-model training-metrics CSV logs, the profiler trace, and the port's spans and counters.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/logging.py``:
``log_training_csv`` with the ``csv`` module instead of pandas (per-epoch
train/val histories at ``logs/<model_name>/metrics.csv``), and ``trace``
with ``torch.profiler`` instead of ``jax.profiler``: CPU activity, and CUDA
activity (every kernel launched, by name) where there is a card, written as
a Chrome trace (chrome://tracing, Perfetto) at
``logs/traces/<name>/trace.json``, with the port's spans of the block on a
row of their own.

Spans and counters (the JAX package has no counterpart):

- ``span(name, new_request=False, **attrs)`` times a block of host code: its
  start and end on ``time.perf_counter_ns``, its parent (the innermost span
  open on the same thread), and a request id. ``new_request=True`` opens a
  new id on its thread; any other span takes its parent's id, or, as a
  root, the last id opened on its thread. Off by default: then ``span``
  tests one flag and hands back a shared no-op context manager (no clock
  read, no allocation). The scoring path's spans are ``serve.*``
  (``core/serve.py``; ``serve.text_tower`` in ``layers.TowerTextEncoder``),
  the text tower's ``tower.attention`` and ``tower.moe``
  (``models/text_tower.py``), the kernel libraries' ``kernels.build`` and
  ``kernels.load`` (``ops/cuda_build.py``).
- ``count(name, n=1)`` adds to a counter, always (a plain integer add, exact
  while one thread at a time counts); ``counters(since)`` reads them. The
  kernels' launches are ``kernels.evidential_heads``,
  ``kernels.evidential_heads_bf16``, ``kernels.probe_epoch`` and
  ``kernels.moe_experts`` (``ops/moe_experts.py``); the text tower's tokens
  ``tower.tokens``; the scoring path's calls ``serve.eager_calls``,
  ``serve.graph_captures`` and ``serve.graph_replays`` (``core/serve.py``).
  ``held_counts()`` holds the counts a thread makes inside a block instead
  of adding them: a CUDA
  graph's capture runs under it, since a capture launches nothing, and each
  replay adds what it held, so a kernel's counter counts its runs on the
  card.
- ``recording()`` turns spans on for a block and yields a
  :class:`Recording`: the spans closed inside it (a bounded buffer that
  counts what it ``dropped``; ``span_table`` sums them by name, with each
  one's self time), the counters' growth over it, and the clock
  anchor that puts spans on the Unix-epoch nanoseconds of the profiler's
  device trace (``prof.profiler.kineto_results.trace_start_ns() + 1000 *
  event.time_range.start`` for an event of a ``torch.profiler`` result).
"""

from __future__ import annotations

import collections
import contextlib
import csv
import itertools
import json
import re
import threading
import time

import numpy as np

from .artifacts import artifact_path

# the ``process`` the spans take in a Chrome trace: a row of their own
SPAN_ROW = "port spans"


def log_training_csv(model_name: str, result, save_dir: str = "logs") -> str:
    """The fit's per-epoch histories at ``<save_dir>/<model_name>/metrics.csv``
    (written by rank 0 alone under a process group); returns its path."""
    from ..parallel.distributed import is_writer

    out = artifact_path(save_dir) / model_name
    path = out / "metrics.csv"
    if not is_writer():
        return str(path)
    out.mkdir(parents=True, exist_ok=True)
    columns = [np.asarray(result.train_loss), np.asarray(result.val_loss),
               np.asarray(result.val_acc)]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["epoch", "train_loss", "val_loss", "val_acc"])
        for epoch, (tl, vl, va) in enumerate(zip(*columns)):
            writer.writerow([epoch, float(tl), float(vl), float(va)])
    return str(path)


class _Off:
    """The span handed out while nothing records: enters to None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Thread(threading.local):
    def __init__(self):
        self.stack = []        # the open spans, innermost last
        self.request = None    # the last request id opened on this thread
        self.held = None       # the Counter of held_counts() while one is open
        self.tid = threading.get_native_id()


class Span:
    """One span, open or closed: ``name``, ``id``, ``parent`` (the id of the
    span it opened inside, or None), ``request``, ``tid`` (the thread's
    native id), ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``) and
    ``attrs`` (which the block may add to)."""

    __slots__ = ("name", "attrs", "new_request", "id", "parent", "request", "tid",
                 "start_ns", "end_ns", "_recorder")

    def __init__(self, recorder, name, new_request, attrs):
        self._recorder, self.name, self.new_request, self.attrs = (
            recorder, name, new_request, attrs)

    def __enter__(self):
        rec = self._recorder
        local = rec._thread
        stack = local.stack
        self.parent = stack[-1].id if stack else None
        if self.new_request:
            local.request = next(rec._requests)
            self.request = local.request
        else:
            self.request = stack[-1].request if stack else local.request
        self.id, self.tid = next(rec._ids), local.tid
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        stack = self._recorder._thread.stack
        if stack and stack[-1] is self:
            stack.pop()
        self._recorder._keep(self)
        return False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recording:
    """What a :meth:`Recorder.recording` block collected: ``spans`` in the
    order they closed (at most ``capacity``; ``dropped`` counts the rest),
    ``counters``, each counter's growth over the block (filled when it
    ends), and ``anchor``, one (``perf_counter_ns``, ``time_ns``) pair read
    when it began."""

    def __init__(self, capacity: int):
        self.capacity, self.spans, self.dropped = capacity, [], 0
        self.counters = collections.Counter()
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        self.anchor = ((p0 + time.perf_counter_ns()) // 2, unix)

    def unix_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` stamp on the Unix-epoch clock of the
        profiler's device trace."""
        return t - self.anchor[0] + self.anchor[1]


class Recorder:
    """The spans and counters of one process (module-level: ``RECORDER``)."""

    def __init__(self):
        self.on = False
        self.counts = {}
        self._active = []
        self._lock = threading.Lock()
        self._thread = _Thread()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)

    def span(self, name: str, new_request: bool = False, **attrs):
        """A context manager timing its block as span ``name`` (entering to
        the :class:`Span`, or to None while nothing records)."""
        if not self.on:
            return _OFF
        return Span(self, name, new_request, attrs)

    def count(self, name: str, n: int = 1) -> None:
        held = self._thread.held
        if held is not None:
            held[name] += n
            return
        self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def held_counts(self):
        """Hold the counts this thread makes inside the block (blocks may
        nest) instead of adding them; yields the Counter that holds them."""
        local = self._thread
        outer, local.held = local.held, collections.Counter()
        try:
            yield local.held
        finally:
            local.held = outer

    def counters(self, since=None) -> collections.Counter:
        """Every counter; with ``since`` (an earlier reading), each one's
        growth since then."""
        now = collections.Counter(self.counts)
        if since is not None:
            now.subtract(since)
        return now

    @contextlib.contextmanager
    def recording(self, capacity: int = 100_000):
        """Record the spans that close inside the block (blocks may nest);
        yields the :class:`Recording`."""
        rec = Recording(capacity)
        start = self.counters()
        with self._lock:
            self._active.append(rec)
            self.on = True
        try:
            yield rec
        finally:
            with self._lock:
                self._active.remove(rec)
                self.on = bool(self._active)
            rec.counters.update(self.counters(start))

    def _keep(self, span: Span) -> None:
        with self._lock:
            for rec in self._active:
                if len(rec.spans) < rec.capacity:
                    rec.spans.append(span)
                else:
                    rec.dropped += 1


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
counters = RECORDER.counters
held_counts = RECORDER.held_counts
recording = RECORDER.recording


def span_table(spans) -> dict:
    """By span name: ``count``, ``total_ns`` and ``self_ns`` (each span's
    time less that of the spans opened directly inside it) of ``spans``."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "total_ns": 0, "self_ns": 0})
        row["count"] += 1
        row["total_ns"] += s.end_ns - s.start_ns
        row["self_ns"] += own[s.id]
    return out


def add_spans_to_chrome_trace(path, rec: Recording) -> None:
    """Append the recording's spans to the kineto Chrome trace at ``path``
    as complete events on a row of their own (``SPAN_ROW``), on the trace's
    clock (microseconds from its ``baseTimeNanoseconds``, Unix-epoch). They
    are spliced in before the end of its ``traceEvents`` list (the trace may
    be hundreds of MB), or, where the file does not end as kineto ends it,
    added through a whole load and dump."""
    with open(path, "rb") as f:
        head = f.read(4096)
        size = f.seek(0, 2)
        f.seek(max(0, size - 4096))
        tail = f.read()
    base = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base_ns = int(base.group(1)) if base else 0
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_ROW, "args": {"name": SPAN_ROW}}]
    events += [{"ph": "X", "cat": "port_span", "name": s.name, "pid": SPAN_ROW, "tid": s.tid,
                "ts": (rec.unix_ns(s.start_ns) - base_ns) / 1e3, "dur": s.duration_ns / 1e3,
                "args": {"id": s.id, "parent": s.parent, "request": s.request,
                         **{k: v if isinstance(v, (int, float, str)) else str(v)
                            for k, v in s.attrs.items()}}}
               for s in rec.spans]
    end = re.search(rb'([}\[])\s*\]\s*(,\s*"traceName"\s*:\s*"[^"]*"\s*)?\}\s*$', tail)
    if end is None:
        with open(path) as f:
            data = json.load(f)
        data.setdefault("traceEvents", []).extend(events)
        with open(path, "w") as f:
            json.dump(data, f)
        return
    at = size - len(tail) + end.start(1) + 1
    text = (",\n" if end.group(1) == b"}" else "\n") + ",\n".join(map(json.dumps, events))
    with open(path, "r+b") as f:
        f.seek(at)
        rest = f.read()
        f.seek(at)
        f.write(text.encode() + rest)


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str = "logs/traces", enabled: bool = True):
    """Profile the block, and record the port's spans in it; the trace is
    written, with the spans on a row of their own, and its directory
    printed, when the block ends, also when it raises. Yields the trace's
    path (None when not ``enabled``). Under a process group rank 0 alone
    traces."""
    from ..parallel.distributed import is_writer

    if not enabled or not is_writer():
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = artifact_path(log_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with recording() as rec, prof:
            yield path
    finally:
        prof.export_chrome_trace(str(path))
        add_spans_to_chrome_trace(path, rec)
        print(f"profiler trace written to {log_dir}/{name}", flush=True)
