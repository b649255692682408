"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work the self-play step asks of the net and of the two tree
kernels, computed from shapes and from the data of the call. A net's
shapes are its layers, as its reference module's ``net_layers`` lists
them (``reference/nets/__init__.py``).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
the 700 W limit); each run prints the card's power limit beside them.
Counting follows the roofline rule: each input byte read once, each output
byte written once, and where the work depends on the data, what these
inputs need.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


Layers = Tuple[list, list]


def conv_flops(layers: Layers) -> float:
    """Multiply-add operations (2 each) of the convolutions, one position.
    ``layers`` is ``net_layers(cfg)`` of the configuration's net module
    (``reference/nets/<net>.py``)."""
    convs, _ = layers
    return float(sum(2 * ci * co * k * k * s * s for ci, co, k, _, s in convs))


def net_flops(layers: Layers) -> float:
    """Operations of one position's forward pass: convolutions and dense
    layers (normalisation and activations are not counted)."""
    _, denses = layers
    return conv_flops(layers) + float(sum(2 * i * o for i, o in denses))


def conv_bytes(layers: Layers, batch: int, elem: int = 2) -> float:
    """Bytes the convolutions of one batched forward pass must move: each
    layer's input read, kernel read and output written once, ``elem``
    bytes an element (bf16)."""
    convs, _ = layers
    total = sum(batch * ci * i * i + co * ci * k * k + batch * co * s * s
                for ci, co, k, i, s in convs)
    return float(total * elem)


def select_bound(depth_sum: float, batch: int, capacity: int, num_actions: int) -> Dict:
    """The least time of one K1 call (the batched PUCT descent) from the
    descent depths of its lanes: the six [B, T] node vectors read once,
    one child_P row per descent step, the two [B, T] path masks and the
    five int32 and one bool [B] outputs written once; per step T parent
    compares and ~18 operations per action."""
    nbytes = 4 * (6 * batch * capacity + depth_sum * num_actions + 2 * batch * capacity
                  + 5 * batch) + batch
    ops = depth_sum * (capacity + 18 * num_actions)
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = ops / F32_FLOPS_PER_S
    return dict(bound_s=max(byte_s, op_s), bound_by="bytes" if byte_s >= op_s else "operations",
                bytes=nbytes, ops=ops)


def rows_bytes(lane_bytes: int, written: int, batch: int) -> float:
    """Bytes of one K2 call (one row per lane into a set of tree arrays):
    the written lanes' rows read and written once, and the int32 slot of
    every lane read."""
    return float(2 * written * lane_bytes + 4 * batch)


def rows_bound(calls: Iterable[Tuple[int, int, int]]) -> float:
    """Least seconds of K2 calls given as (lane_bytes, written, batch)."""
    return sum(rows_bytes(*c) for c in calls) / HBM_BYTES_PER_S
