"""The whole step's share of the card's bf16 peak: the net's forward
operations of every evaluation in the window's unprofiled moves, over
those moves' seconds on the host's clock."""

from azbench import arith


def read(trace):
    if not trace or not trace.get("mfu_seconds"):
        return None
    return 100.0 * trace["mfu_flops"] / trace["mfu_seconds"] / arith.BF16_FLOPS_PER_S
