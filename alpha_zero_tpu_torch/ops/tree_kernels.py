"""Hand-written CUDA kernels for the MCTS tree hot loop.

``select_leaf_batched`` is the batched PUCT descent of every game's tree
(the port of ``alpha_zero_tpu/ops/tree_kernels.py:select_leaf_batched``).
For tensors on the CPU it runs the plain PyTorch version,
``select_leaf_plain``; for CUDA tensors it launches the kernel in
``csrc/select_leaf.cu`` or raises. The two compute the same bits. A call on
the card is one kernel launch: the kernel writes every output into three
``torch.empty`` buffers. ``.launches`` counts the launches; a call made
while a CUDA graph is being captured only records the kernel and is not
counted, nor are the graph's replays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from alpha_zero_tpu_torch.ops import _build

_VEC_ARGS = ("node_N", "node_W", "node_P", "parent_index",
             "action_from_parent", "node_done")
_MAX_SLOTS = 65535  # the kernel packs a slot, an action and a step into 16 bits


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = _build.load("select_leaf")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # 7 inputs, B/T/A/path_cap, c_puct base/init, 3 outputs, device, stream.
    lib.azt_select_leaf.argtypes = [p] * 7 + [i] * 4 + [f] * 2 + [p] * 3 + [i, p]
    lib.azt_select_leaf.restype = i
    lib.azt_cuda_error_string.argtypes = [i]
    lib.azt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(vecs, child_P: torch.Tensor) -> Tuple[int, int, int]:
    """One pass over the seven inputs; returns ``(B, T, A)``."""
    if child_P.dim() != 3:
        raise ValueError(f"child_P must be [B, T, A], got {tuple(child_P.shape)}")
    b, t, a = child_P.shape
    dev = child_P.device
    for name, v in zip(_VEC_ARGS + ("child_P",), vecs + (child_P,)):
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, child_P on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v is not child_P and v.shape != (b, t):
            raise ValueError(f"{name} must be [{b}, {t}], got {tuple(v.shape)}")
    return b, t, a


def select_leaf_plain(node_N, node_W, node_P, parent_index, action_from_parent,
                      node_done, child_P, *, path_cap: int, c_puct_base: float,
                      c_puct_init: float) -> Tuple:
    """Descends every tree by PUCT from the root until an unmaterialized
    edge, a terminal child or ``path_cap`` steps.

    At each step the current node's existing children score
    ``-W/max(N,1) + pb_c*max(P,0)*(sqrt(n)/(1+N))`` from the [B, T] vectors
    and land at their action; unvisited legal actions score from the node's
    ``child_P`` row, illegal ones -9999; the first maximum wins. The visited
    nodes are recorded in two [B, T] masks by depth parity.

    Returns what ``select_leaf_batched`` returns (int32
    parent/action/child/depth, bool hit_terminal, f32 even/odd/p_sel) —
    the kernel computes the same bits. Each lane's loop stops on its own;
    finished lanes are masked while the others go on.
    """
    batch, capacity = node_N.shape
    num_actions = child_P.shape[-1]
    dev = node_N.device
    bidx = torch.arange(batch, device=dev)
    t_iota = torch.arange(capacity, device=dev)
    # A tensor divisor: PyTorch's CUDA division by a Python float multiplies
    # by the reciprocal, which is not the IEEE division the kernel does.
    base = torch.tensor(c_puct_base, dtype=torch.float32, device=dev)
    q_t = node_W / torch.clamp_min(node_N, 1.0)

    cur = torch.zeros((batch,), dtype=torch.long, device=dev)
    n_cur = node_N[:, 0].clone()
    action = torch.full((batch,), -1, dtype=torch.long, device=dev)
    child = torch.full((batch,), -1, dtype=torch.long, device=dev)
    p_sel = torch.zeros((batch,), dtype=torch.float32, device=dev)
    depth = torch.zeros((batch,), dtype=torch.long, device=dev)
    live = torch.full((batch,), path_cap > 0, dtype=torch.bool, device=dev)
    even = torch.zeros((batch, capacity), dtype=torch.float32, device=dev)
    odd = torch.zeros((batch, capacity), dtype=torch.float32, device=dev)

    while bool(live.any()):
        # Same expression tree as the kernel (and the JAX package).
        pb_c = torch.log((1.0 + n_cur + c_puct_base) / base) + c_puct_init
        sqrt_n = torch.sqrt(n_cur)
        u_t = pb_c[:, None] * torch.clamp_min(node_P, 0.0) * (
            sqrt_n[:, None] / (1.0 + node_N))
        score_t = -q_t + u_t
        # Scatter each child's score and slot to its action; non-children
        # go to a dump column A.
        is_child = parent_index == cur[:, None].float()
        slot_a = torch.where(is_child, action_from_parent,
                             float(num_actions)).long()
        score_A = torch.zeros((batch, num_actions + 1), device=dev).scatter_(
            1, slot_a, score_t)[:, :num_actions]
        child_A = torch.full((batch, num_actions + 1), -1, dtype=torch.long,
                             device=dev).scatter_(
            1, slot_a, t_iota.expand(batch, -1))[:, :num_actions]
        p_row = child_P[bidx, cur]
        fresh = -0.0 + pb_c[:, None] * torch.clamp_min(p_row, 0.0) * (
            sqrt_n[:, None] / 1.0)
        scores = torch.where(p_row >= 0.0,
                             torch.where(child_A >= 0, score_A, fresh), -9999.0)
        act_new = scores.argmax(dim=1)
        child_new = child_A[bidx, act_new]
        p_new = p_row[bidx, act_new]
        child_c = child_new.clamp(0, capacity - 1)
        is_new = child_new < 0
        stop = is_new | (node_done[bidx, child_c] > 0.5)

        rec = (t_iota[None, :] == cur[:, None]) & live[:, None]
        is_even = (depth % 2 == 0)[:, None]
        even = torch.where(rec & is_even, 1.0, even)
        odd = torch.where(rec & ~is_even, 1.0, odd)

        move_on = live & ~stop
        cur = torch.where(move_on, child_c, cur)
        n_cur = torch.where(move_on, node_N[bidx, child_c], n_cur)
        action = torch.where(live, act_new, action)
        child = torch.where(live, child_new, child)
        p_sel = torch.where(live, p_new, p_sel)
        depth = depth + live.long()
        live = live & ~stop & (depth < path_cap)

    i32 = torch.int32
    return (cur.to(i32), action.to(i32), child.to(i32), child >= 0, even, odd,
            depth.to(i32), p_sel)



def select_leaf_batched(node_N, node_W, node_P, parent_index,
                        action_from_parent, node_done, child_P, *,
                        path_cap: int, c_puct_base: float,
                        c_puct_init: float) -> Tuple:
    """Batched PUCT descent from every root.

    Inputs are the tree's f32 ``[B, T]`` node vectors and ``child_P
    [B, T, A]``. Returns ``(parent, action, child, hit_terminal, even, odd,
    depth, p_sel)``: int32 ``[B]`` parent/action/child (-1 when the chosen
    edge has no node)/depth, bool ``[B]`` hit_terminal, f32 ``[B, T]``
    path masks by depth parity, and f32 ``[B]`` prior of the chosen edge.
    """
    vecs = (node_N, node_W, node_P, parent_index, action_from_parent, node_done)
    b, t, a = _check_inputs(vecs, child_P)
    dev = child_P.device
    if dev.type == "cpu":
        return select_leaf_plain(*vecs, child_P, path_cap=path_cap,
                                 c_puct_base=c_puct_base, c_puct_init=c_puct_init)
    if dev.type != "cuda":
        raise ValueError(f"no select kernel for device {dev}")
    if not (1 <= t <= _MAX_SLOTS and 1 <= a <= _MAX_SLOTS and path_cap < _MAX_SLOTS):
        raise ValueError(f"the select kernel takes T and A in [1, {_MAX_SLOTS}] and "
                         f"path_cap < {_MAX_SLOTS}; got T={t}, A={a}, path_cap={path_cap}")

    ints = torch.empty((5, b), dtype=torch.int32, device=dev)
    hit = torch.empty((b,), dtype=torch.bool, device=dev)
    masks = torch.empty((2, b, t), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.azt_select_leaf(
        *(v.data_ptr() for v in vecs), child_P.data_ptr(),
        b, t, a, path_cap, c_puct_base, c_puct_init,
        ints.data_ptr(), hit.data_ptr(), masks.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("select_leaf kernel launch failed: "
                           + lib.azt_cuda_error_string(rc).decode())
    if b and not torch.cuda.is_current_stream_capturing():
        select_leaf_batched.launches += 1
    parent, action, child, depth = ints[:4]
    return parent, action, child, hit, masks[0], masks[1], depth, ints[4].view(torch.float32)


select_leaf_batched.launches = 0
