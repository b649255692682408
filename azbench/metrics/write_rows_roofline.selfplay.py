"""K2's share of its roofline: the bytes of the rows each call writes
(``arith.rows_bytes``) at the HBM peak, over the kernel's device time."""


def read(trace):
    if not trace or not trace.get("k2_device_s"):
        return None
    return 100.0 * trace["k2_bound_s"] / trace["k2_device_s"]
