"""Host ms a batch inside `AlignEngine.iter_buckets`: sorting, bucketing
and `build_bucket_arrays`' packing (the method of the port's
`probes.colsweep_cells.host_split`)."""


def read(trace):
    v = trace["spans"].get("pack") or []
    return 1e3 * sum(v) / len(v) if v else None
