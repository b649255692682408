"""Device kernels of one move: those of the profiled stretch, scaled to a
move by the select launches a move over the select launches in it."""


def read(trace):
    if not trace or not trace.get("move_scale"):
        return None
    return trace["kernel_count"] * trace["move_scale"]
