"""One reader per end-to-end metric: ``read(window) -> float``, found by
the metric's name in ``BENCHMARK.json``."""
