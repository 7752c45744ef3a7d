"""One reader per per-layer metric: ``read(trace, ctx) -> float | None``
(None when the trace holds nothing to read), found by the metric's name
in ``BENCHMARK.json``. ``trace`` is a ``phybench.tracing.Trace`` of the
traced calls; ``ctx`` holds the ``driver``, ``conf``, ``traffic`` and the
``iterations`` each traced call returned."""
