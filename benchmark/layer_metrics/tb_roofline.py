"""The traceback path's share of its roofline, in %: the least time of
the window's alignments with CIGARs ((12 + 8) operations an in-band cell
and 10 a move of the path, or the bytes) over the device time of all
kernels that ran in the window."""


def read(trace):
    k = trace["device"]["kernel_s"]
    if not trace["traceback"] or k <= 0:
        return None
    return 100.0 * trace["least_s"] / k
