"""Per-layer metric readers, one file a metric, named as in
``BENCHMARK.json``.  Each ``read(trace)`` takes the traced run's readings
(``index_serving.py``: ``steps``, ``latency_s``, ``phase_s``,
``phase_calls``, ``k1_bound_s``, ``k2_bound_s``, ``device``) and returns the
metric, or None where there is nothing to read; never 0 for a share."""
