"""Per-layer metric readers, one file a metric, named after it.

Each file has `read(trace) -> float | None`.  ``trace`` is the dict
`benchmark.harness` builds from a `--trace 1` run: "spans" (host seconds
a completed batch spent in each span: encode, pack, copy, launch,
collect), "pairs" and "n_buckets" (a batch's), "traceback", "least_s"
(the least time the card could take for all of the window's batches,
`benchmark.roofline`) and "device" (seconds from the profiler's trace:
kernel_s, kernel_busy_s, busy_s, window_s, source).  A reader that finds nothing to read returns None, and the
metric is left out of the line.
"""
