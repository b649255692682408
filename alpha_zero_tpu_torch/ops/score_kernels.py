"""Tromp-Taylor area scoring of a batch of Go boards as one CUDA kernel.

``score_area`` (K4) counts each board's black and white area and its score
after komi. For tensors on the CPU it runs the plain version, the engine's
own ``GoEngine.area_counts_plain`` (empty regions labelled by sweeps of
whole-batch ops until a host read finds the labels settled); for CUDA
tensors it launches the kernel in ``csrc/score_area.cu`` or raises. The
two compute the same bits. A call on the card is one kernel launch and
reads nothing back: a lane outside the mask is skipped by the kernel.
``score_area.launches`` counts the launches; a call made while a CUDA graph
is being captured only records the kernel and is not counted, nor are the
graph's replays.
"""

from __future__ import annotations

import ctypes

import torch

from alpha_zero_tpu_torch.ops import _build

MAX_CELLS = 1024  # the largest N * N the kernel takes: N <= 32 (csrc/score_area.cu:kMaxSide)

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIBRARY = "score_area", {
    # board, mask, B, N, komi, out
    "azt_score_area": [_P, _P, _I, _I, ctypes.c_float, _P],
}


def _check_inputs(engine, board: torch.Tensor, mask) -> None:
    n = engine.board_size
    if board.dim() != 3 or board.shape[1:] != (n, n):
        raise ValueError(f"board must be [B, {n}, {n}], got {tuple(board.shape)}")
    if n * n > MAX_CELLS:
        raise ValueError(f"the scoring kernel takes N * N <= {MAX_CELLS}; got N={n}")
    if board.dtype != torch.int8:
        raise TypeError(f"board must be int8, got {board.dtype}")
    if not board.is_contiguous():
        raise ValueError("board must be contiguous")
    if mask is None:
        return
    if mask.dtype != torch.bool or mask.shape != board.shape[:1]:
        raise ValueError(f"mask must be bool [{board.shape[0]}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != board.device:
        raise ValueError(f"mask is on {mask.device}, board on {board.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")


def score_area(engine, board: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """f32 ``[3, B]``: each board's black area, white area and score
    ``(black - white) - engine.komi`` under ``engine``'s rules
    (Tromp-Taylor, no dead-stone removal), for int8 ``board [B, N, N]``
    with ``N == engine.board_size`` and ``N * N <= MAX_CELLS``. With a
    bool ``mask [B]``, a lane outside it reads 0 in all three."""
    _check_inputs(engine, board, mask)
    dev = board.device
    if dev.type == "cpu":
        black, white = engine.area_counts_plain(board)
        out = torch.stack([black, white, (black - white) - engine.komi])
        return out if mask is None else torch.where(mask, out, 0.0)
    if dev.type != "cuda":
        raise ValueError(f"no scoring kernel for device {dev}")
    b = board.shape[0]
    out = torch.empty((3, b), dtype=torch.float32, device=dev)
    if _build.launch(_LIBRARY, "azt_score_area", dev,
                     board.data_ptr(), None if mask is None else mask.data_ptr(), b,
                     engine.board_size, engine.komi, out.data_ptr()) and b:
        score_area.launches += 1
    return out


score_area.launches = 0
