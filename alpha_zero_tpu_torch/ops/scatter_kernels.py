"""Hand-written CUDA kernels that write one row per lane into a tree array.

Both compute, in place, ``arr[b, widx[b], :] = rows[b]`` for every lane
with ``0 <= widx[b] < T`` and leave every other byte of ``arr`` as it was
(``arr`` f32 ``[B, T, W]``, ``rows`` f32 ``[B, W]``, ``widx`` int32 ``[B]``):

- ``scatter_rows`` is the port of the row-DMA kernel
  ``tools/dma_probe.py:scatter_kernel``: one warp per lane, any ``W``.
- ``scatter_rows_bulk`` is the port of ``tools/dma_probe.py:
  scatter_kernel_overlap``: rows staged in shared memory and written by
  the bulk-copy (TMA) unit. It takes ``W % 4 == 0`` and 16-byte-aligned
  ``arr`` and ``rows`` only, and raises otherwise.

For tensors on the CPU the wrappers run the plain version,
``blend_scatter``, and copy its result into ``arr``; for CUDA tensors they
launch the kernel in ``csrc/scatter_rows.cu`` or raise. The two compute the
same bits. Each wrapper's ``.launches`` counts the kernels it launches; a
call made while a CUDA graph is being captured only records the kernel and
is not counted, nor are the graph's replays.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alpha_zero_tpu_torch.ops import _build

_BULK_ALIGN = 16  # bytes: what cp.async.bulk needs of addresses and sizes


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = _build.load("scatter_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.azt_scatter_rows, lib.azt_scatter_rows_bulk):
        fn.argtypes = [p, p, p, i, i, i, p]  # arr, rows, widx, B, T, W, stream
        fn.restype = i
    lib.azt_cuda_error_string.argtypes = [i]
    lib.azt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def blend_scatter(arr: torch.Tensor, rows: torch.Tensor,
                  widx: torch.Tensor) -> torch.Tensor:
    """The plain version: a new ``[B, T, W]`` tensor that holds ``rows[b]``
    at ``[b, widx[b]]`` and ``arr`` elsewhere (the dense one-hot blend of
    ``tools/dma_probe.py:blend_scatter``). A ``widx`` outside ``[0, T)``
    selects no slot."""
    t_iota = torch.arange(arr.shape[1], dtype=widx.dtype, device=arr.device)
    onehot = (t_iota[None, :] == widx[:, None])[:, :, None]
    return torch.where(onehot, rows[:, None, :], arr)


def _check_inputs(arr: torch.Tensor, rows: torch.Tensor, widx: torch.Tensor,
                  bulk: bool) -> None:
    if arr.dim() != 3:
        raise ValueError(f"arr must be [B, T, W], got {tuple(arr.shape)}")
    b, _, w = arr.shape
    for name, x, shape, dtype in (("arr", arr, tuple(arr.shape), torch.float32),
                                  ("rows", rows, (b, w), torch.float32),
                                  ("widx", widx, (b,), torch.int32)):
        if x.device != arr.device:
            raise ValueError(f"{name} is on {x.device}, arr on {arr.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bulk:
        if (w * arr.element_size()) % _BULK_ALIGN:
            raise ValueError(f"scatter_rows_bulk copies rows of whole 16-byte "
                             f"units: W must be a multiple of 4, got {w}")
        for name, x in (("arr", arr), ("rows", rows)):
            if x.data_ptr() % _BULK_ALIGN:
                raise ValueError(f"scatter_rows_bulk needs {name} 16-byte aligned "
                                 f"(a view with a storage offset may not be)")


def _scatter(entry: str, wrapper, arr: torch.Tensor, rows: torch.Tensor,
             widx: torch.Tensor) -> torch.Tensor:
    _check_inputs(arr, rows, widx, bulk=wrapper is scatter_rows_bulk)
    if arr.numel() == 0:
        return arr  # no row to write
    if arr.device.type == "cpu":
        return arr.copy_(blend_scatter(arr, rows, widx))
    if arr.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {arr.device}")
    b, t, w = arr.shape
    lib = _library()
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        rc = getattr(lib, entry)(arr.data_ptr(), rows.data_ptr(), widx.data_ptr(),
                                 b, t, w, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + lib.azt_cuda_error_string(rc).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture records, launches nothing
        wrapper.launches += 1
    return arr


def scatter_rows(arr: torch.Tensor, rows: torch.Tensor,
                 widx: torch.Tensor) -> torch.Tensor:
    """``arr[b, widx[b]] = rows[b]`` where ``0 <= widx[b] < T``, in place;
    returns ``arr``. Any ``W``."""
    return _scatter("azt_scatter_rows", scatter_rows, arr, rows, widx)


def scatter_rows_bulk(arr: torch.Tensor, rows: torch.Tensor,
                      widx: torch.Tensor) -> torch.Tensor:
    """``scatter_rows`` through the bulk-copy unit; ``W`` a multiple of 4,
    ``arr`` and ``rows`` 16-byte aligned, or ``ValueError``."""
    return _scatter("azt_scatter_rows_bulk", scatter_rows_bulk, arr, rows, widx)


scatter_rows.launches = 0
scatter_rows_bulk.launches = 0
