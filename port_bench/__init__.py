"""The benchmark of ``disentagled_multimodal_fusion_tpu_torch`` on one NVIDIA H100.

One command runs one cell once, from the root of a checkout:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line (the last line of standard output). The cells,
configurations and metrics are data: ``BENCHMARK.json`` at the root names
them, and the harness finds what belongs to each by that name, in files of
its own under this folder:

* ``workloads/<cell>.json``: the cell's configuration, its ``loop``, and
  what that loop reads: for the closed scoring loop the served model, the
  traffic (corpus rows, rows per request), how many requests the check
  compares, and the limit of each number compared (a workload file that
  ``BENCHMARK.json`` does not name is a mix kept for later: a later change
  runs it by adding its entry and metrics);
* ``loops/<loop>.py``: the cell's set-up, its measured window and the
  check that decides ``correct`` (``loops/closed.py``: one client scoring
  consecutive requests of a corpus on the card);
* ``configs/<config>.json``: the configuration's published widths, its
  source, ``reduced`` and ``assumed``, and how its corpus is made;
* ``models/<config>.py``: the port's inference function for the
  configuration, and the model FLOPs and the head kernel's shapes counted
  from the published widths;
* ``reference/<config>.py``: the plain PyTorch reference that decides
  ``correct`` (it imports nothing of the port);
* ``metrics/<quantity>.py``: the reader of every metric, end-to-end or
  per-layer, named ``<quantity>`` or ``<quantity>.<suffix>`` (the suffix
  names the cells that report it), ``read(r)`` over the run's readings,
  returning None where it finds nothing to read.

A later change adds a cell, a configuration, a loop or a metric by adding
such files and entries to ``BENCHMARK.json``; no file of the harness needs
an edit for it (``tests/test_port_bench_registry.py`` shows it from a
scratch folder). The yardstick lives here: traffic (``traffic.py``), the
H100's peaks and the head kernel's bound (``bounds.py``), the reduction of
the profiler's trace (``trace.py``), the weights drawn from the seed
(``weights.py``) and the comparison that decides ``correct``
(``compare.py``). Nothing here imports JAX or the JAX package.
"""
