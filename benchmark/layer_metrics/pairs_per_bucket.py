"""Pairs a bucket: the window's pairs over `AlignmentResult.n_buckets`."""


def read(trace):
    b = sum(trace["n_buckets"])
    return sum(trace["pairs"]) / b if b else None
