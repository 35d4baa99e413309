"""The benchmark of ``k8s_tpu_torch``, the PyTorch and CUDA port.

One run measures one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so a cell, a configuration or a per-layer
metric is added as a file and no existing file is edited:

- ``configs/<config>.json``: the published configuration as it is run;
- ``workloads/<cell>.json``: the cell's configuration, driver, traffic
  and the limits of its correctness check;
- ``drivers/<kind>.py``: one file for each kind of entry (``train``,
  ``serve``), with ``run(ctx)``;
- ``metrics/<metric>.py``: one reader for each per-layer metric of
  ``BENCHMARK.json``, with ``read(record)``.

The yardstick lives here and nowhere in the program: the traffic
generator (``traffic.py``), the peaks and the operation and byte counts
(``flops.py``), the timers and the profiler's reduction
(``common.py``), the plain reference (``reference/``) and the
comparison that decides ``correct``.  Nothing here imports JAX or the
JAX package, and ``reference/`` imports nothing of the port.
"""
