"""cuDNN's NCHW/NHWC layout transposes as a share of the device's busy time."""


def read(trace):
    if not trace or not trace.get("busy_s") or not trace.get("transpose_s"):
        return None
    return 100.0 * trace["transpose_s"] / trace["busy_s"]
