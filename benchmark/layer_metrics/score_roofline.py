"""The score path's share of its roofline, in %: the least time of the
window's alignments (12 int32 operations an in-band cell over the peak,
or their bytes over HBM) over the device time of all kernels that ran in
the window, whatever kernel or route served them."""


def read(trace):
    k = trace["device"]["kernel_s"]
    if trace["traceback"] or k <= 0:
        return None
    return 100.0 * trace["least_s"] / k
