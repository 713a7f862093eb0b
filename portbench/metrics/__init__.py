"""One reader per metric, found by the metric's name in BENCHMARK.json.

``read(record)`` takes a :class:`portbench.harness.Record` and returns the
metric's value, or None when the run has nothing to read for it (then the
metric is left out of the result line).
"""
