"""The share of the traced window, in %, in which no kernel ran on the
card (the union of kernel intervals; copies count as idle)."""


def read(trace):
    d = trace["device"]
    if d["source"] == "none" or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["kernel_busy_s"] / d["window_s"])
