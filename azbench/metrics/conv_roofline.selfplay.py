"""The convolutions' share of their roofline: the least time of their
operations (at the bf16 peak) or bytes (at the HBM peak), over the device
time of every kernel the convolution ops launched, cuDNN's transposes
included."""

from azbench import arith


def read(trace):
    if not trace or not trace.get("conv_launched_s") or not trace.get("conv_flops"):
        return None
    bound = max(trace["conv_flops"] / arith.BF16_FLOPS_PER_S,
                trace["conv_bytes"] / arith.HBM_BYTES_PER_S)
    return 100.0 * bound / trace["conv_launched_s"]
