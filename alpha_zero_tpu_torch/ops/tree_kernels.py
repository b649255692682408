"""Hand-written CUDA kernels for the MCTS tree hot loop.

``select_leaf_batched`` is the batched PUCT descent of every game's tree
(the port of ``alpha_zero_tpu/ops/tree_kernels.py:select_leaf_batched``).
For tensors on the CPU it runs the plain PyTorch version,
``search/mcts.py:_select_leaf``; for CUDA tensors it launches the kernel in
``csrc/select_leaf.cu`` or raises. The two compute the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from alpha_zero_tpu_torch.ops import _build

_VEC_ARGS = ("node_N", "node_W", "node_P", "parent_index",
             "action_from_parent", "node_done")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = _build.load("select_leaf")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # 7 inputs, B/T/A/path_cap, c_puct base/init, 7 outputs, the stream.
    lib.azt_select_leaf.argtypes = [p] * 7 + [i] * 4 + [f] * 2 + [p] * 7 + [p]
    lib.azt_select_leaf.restype = i
    lib.azt_cuda_error_string.argtypes = [i]
    lib.azt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(vecs, child_P: torch.Tensor) -> None:
    if child_P.dim() != 3:
        raise ValueError(f"child_P must be [B, T, A], got {tuple(child_P.shape)}")
    b, t, _ = child_P.shape
    for name, v in zip(_VEC_ARGS + ("child_P",), vecs + (child_P,)):
        if v.device != child_P.device:
            raise ValueError(f"{name} is on {v.device}, child_P on {child_P.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "child_P" and tuple(v.shape) != (b, t):
            raise ValueError(f"{name} must be [{b}, {t}], got {tuple(v.shape)}")


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
    _check_inputs(vecs, child_P)
    kw = dict(path_cap=path_cap, c_puct_base=c_puct_base, c_puct_init=c_puct_init)
    if child_P.device.type == "cpu":
        from alpha_zero_tpu_torch.search.mcts import _select_leaf

        return _select_leaf(*vecs, child_P, **kw)
    if child_P.device.type != "cuda":
        raise ValueError(f"no select kernel for device {child_P.device}")

    b, t, a = child_P.shape
    dev = child_P.device
    ints = torch.empty((4, b), dtype=torch.int32, device=dev)
    p_sel = torch.empty((b,), dtype=torch.float32, device=dev)
    even = torch.zeros((b, t), dtype=torch.float32, device=dev)
    odd = torch.zeros((b, t), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.azt_select_leaf(
            *(v.data_ptr() for v in vecs), child_P.data_ptr(),
            b, t, a, path_cap, c_puct_base, c_puct_init,
            *(ints[k].data_ptr() for k in range(4)), p_sel.data_ptr(),
            even.data_ptr(), odd.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("select_leaf kernel launch failed: "
                           + lib.azt_cuda_error_string(rc).decode())
    select_leaf_batched.launches += 1
    parent, action, child, depth = ints
    return parent, action, child, child >= 0, even, odd, depth, p_sel


select_leaf_batched.launches = 0
