"""Share of the profiled stretch in which no operation ran on the card."""


def read(trace):
    if not trace or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
