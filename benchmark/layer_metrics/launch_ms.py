"""Host ms a batch inside the engine's kernel launchers (the benchmark's
`launch` span around `align_bucket`, `align_bucket_traceback`,
`align_bucket_colsweep`, `align_bucket_colband` and `align_shards`):
the launches' Python, argument checks and ctypes calls, no wait for the
card."""


def read(trace):
    v = trace["spans"].get("launch") or []
    return 1e3 * sum(v) / len(v) if v else None
