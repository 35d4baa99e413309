"""One reader for each per-layer metric of ``BENCHMARK.json``, in a file
named after the metric: ``read(record) -> value | None``.  ``record`` is
what the cell's run gathered in a ``--trace 1`` run; a reader that
finds nothing to read returns None and the metric is left out of the
line.  ``run.py`` loads a reader by its file's path."""
