"""K1's share of its roofline: the least time of each call from its
lanes' descent depths (``arith.select_bound``), over the kernel's device
time."""


def read(trace):
    if not trace or not trace.get("k1_device_s"):
        return None
    return 100.0 * trace["k1_bound_s"] / trace["k1_device_s"]
