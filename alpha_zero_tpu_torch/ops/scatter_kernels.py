"""Hand-written CUDA kernels that write one row per lane into tree arrays.

Both take N arrays (``1 <= N <= MAX_ARRAYS``) and one int32 ``widx [B]``
that all of them share. Array i is ``arr_i [B, T_i, *row_i]``, contiguous,
of any dtype; its rows ``rows_i [B, *row_i]`` are contiguous and of the
same dtype. In place, for every lane with ``0 <= widx[b] < T_i``,
``arr_i[b, widx[b]] = rows_i[b]``; every other byte stays as it was:

- ``write_rows`` (K2, the port of the row-DMA kernel
  ``tools/dma_probe.py:scatter_kernel``) writes a whole set in one launch,
  rows of any byte width. The search's tree writes go through it: 13
  arrays when a node is materialized, 2 when it is expanded.
- ``write_rows_bulk`` (K3, the port of ``tools/dma_probe.py:
  scatter_kernel_overlap``) moves the rows through shared memory by the
  bulk-copy (TMA) unit. It takes rows of whole 16-byte units at 16-byte
  aligned addresses only, and raises otherwise.

``scatter_rows`` and ``scatter_rows_bulk`` are the single-array f32 case
``arr [B, T, W]``, the function of the TPU probe.

For tensors on the CPU the wrappers run the plain version,
``write_rows_plain`` (the search's former ``_put_rows``, applied array by
array); for CUDA tensors they launch the kernel in
``csrc/scatter_rows.cu`` or raise. The two write the same bytes.
``blend_scatter`` is the dense plain version of the single-array function
that the probe holds every variant to. ``write_rows.launches`` and
``write_rows_bulk.launches`` count the kernels launched; a call made while
a CUDA graph is being captured only records the kernel and is not counted,
nor are the graph's replays.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from alpha_zero_tpu_torch.ops import _build

MAX_ARRAYS = 16  # arrays in one call (csrc/scatter_rows.cu:kMaxArrays)
BULK_ALIGN = 16  # bytes: what cp.async.bulk needs of addresses and sizes
BULK_LANE_BYTES = 28 * 1024  # most row bytes a lane stages (kBulkLaneBytes)

# n, dst[n], src[n], row_bytes[n], T[n], widx, B
_SET = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.c_int]
_LIBRARY = "scatter_rows", {"azt_scatter_rows": _SET, "azt_scatter_rows_bulk": _SET}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def put_rows(arr: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
             rows: torch.Tensor, write: torch.Tensor) -> None:
    """``arr[b, slot[b]] = rows[b]`` where ``write[b]``; other lanes write
    their old row back (no host sync to drop them). ``slot`` must lie in
    ``[0, T)``."""
    old = arr[bidx, slot]
    mask = write.reshape(write.shape + (1,) * (old.dim() - 1))
    arr[bidx, slot] = torch.where(mask, rows.to(arr.dtype), old)


def write_rows_plain(arrays: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                     widx: torch.Tensor) -> None:
    """The plain tree-row writer: ``put_rows`` array by array, with
    ``slot = clamp(widx, 0, T - 1)`` and ``write = 0 <= widx < T``."""
    bidx = torch.arange(widx.shape[0], device=widx.device)
    for arr, r in zip(arrays, rows):
        t = arr.shape[1]
        put_rows(arr, bidx, widx.clamp(0, t - 1).long(), r,
                 (widx >= 0) & (widx < t))


def blend_scatter(arr: torch.Tensor, rows: torch.Tensor,
                  widx: torch.Tensor) -> torch.Tensor:
    """The dense plain version of one array: a new ``[B, T, W]`` tensor that
    holds ``rows[b]`` at ``[b, widx[b]]`` and ``arr`` elsewhere (the one-hot
    blend of ``tools/dma_probe.py:blend_scatter``). A ``widx`` outside
    ``[0, T)`` selects no slot."""
    t_iota = torch.arange(arr.shape[1], dtype=widx.dtype, device=arr.device)
    onehot = (t_iota[None, :] == widx[:, None])[:, :, None]
    return torch.where(onehot, rows[:, None, :], arr)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_set(arrays, rows, widx: torch.Tensor, bulk: bool) -> None:
    """O(1) checks per array; raises on anything the kernels do not take."""
    if not 1 <= len(arrays) <= MAX_ARRAYS:
        raise ValueError(f"1 to {MAX_ARRAYS} arrays a call, got {len(arrays)}")
    if len(rows) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays but {len(rows)} row tensors")
    dev = widx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no row-writer kernel for device {dev}")
    if widx.dtype != torch.int32:
        raise TypeError(f"widx must be torch.int32, got {widx.dtype}")
    if widx.dim() != 1 or not widx.is_contiguous():
        raise ValueError(f"widx must be a contiguous [B], got {tuple(widx.shape)}")
    b = widx.shape[0]
    lane_bytes = 0
    for k, (arr, r) in enumerate(zip(arrays, rows)):
        if arr.device != dev or r.device != dev:
            raise ValueError(f"array {k} is on {arr.device} and its rows on "
                             f"{r.device}, widx on {dev}")
        if r.dtype != arr.dtype:
            raise TypeError(f"array {k} is {arr.dtype}, its rows {r.dtype}")
        if arr.dim() < 2 or arr.shape[0] != b or r.shape != (b,) + arr.shape[2:]:
            raise ValueError(f"array {k} must be [B={b}, T, *row] with rows "
                             f"[B, *row]; got {tuple(arr.shape)} and {tuple(r.shape)}")
        if not (arr.is_contiguous() and r.is_contiguous()):
            raise ValueError(f"array {k} and its rows must be contiguous")
        if bulk:
            row = math.prod(r.shape[1:]) * r.element_size()
            if row % BULK_ALIGN:
                raise ValueError(f"write_rows_bulk copies rows of whole 16-byte "
                                 f"units; array {k} has {row}-byte rows")
            if arr.data_ptr() % BULK_ALIGN or r.data_ptr() % BULK_ALIGN:
                raise ValueError(f"write_rows_bulk needs array {k} and its rows "
                                 f"16-byte aligned (a view with a storage offset "
                                 f"may not be)")
            lane_bytes += row
    if lane_bytes > BULK_LANE_BYTES:
        raise ValueError(f"write_rows_bulk stages at most {BULK_LANE_BYTES} bytes "
                         f"of rows a lane, got {lane_bytes}")


def _write(entry: str, wrapper, arrays, rows, widx: torch.Tensor) -> None:
    _check_set(arrays, rows, widx, bulk=wrapper is write_rows_bulk)
    live = [(a, r) for a, r in zip(arrays, rows) if a.numel()]
    if not live:
        return  # no row to write
    if widx.device.type == "cpu":
        write_rows_plain([a for a, _ in live], [r for _, r in live], widx)
        return
    n = len(live)
    dst = (ctypes.c_uint64 * n)(*(a.data_ptr() for a, _ in live))
    src = (ctypes.c_uint64 * n)(*(r.data_ptr() for _, r in live))
    row_bytes = (ctypes.c_int64 * n)(*(math.prod(r.shape[1:]) * r.element_size()
                                       for _, r in live))
    slots = (ctypes.c_int * n)(*(a.shape[1] for a, _ in live))
    if _build.launch(_LIBRARY, entry, widx.device, n, dst, src, row_bytes, slots,
                     widx.data_ptr(), widx.shape[0]):
        wrapper.launches += 1


def write_rows(arrays: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
               widx: torch.Tensor) -> None:
    """``arrays[i][b, widx[b]] = rows[i][b]`` where ``0 <= widx[b] < T_i``,
    in place, for every array of the set in one launch (K2)."""
    _write("azt_scatter_rows", write_rows, arrays, rows, widx)


def write_rows_bulk(arrays: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                    widx: torch.Tensor) -> None:
    """``write_rows`` through the bulk-copy unit (K3): rows of whole 16-byte
    units at 16-byte-aligned addresses, or ``ValueError``."""
    _write("azt_scatter_rows_bulk", write_rows_bulk, arrays, rows, widx)


write_rows.launches = 0
write_rows_bulk.launches = 0


def _check_f32(arr: torch.Tensor) -> None:
    if arr.dim() != 3:
        raise ValueError(f"arr must be [B, T, W], got {tuple(arr.shape)}")
    if arr.dtype != torch.float32:
        raise TypeError(f"arr must be torch.float32, got {arr.dtype}")


def scatter_rows(arr: torch.Tensor, rows: torch.Tensor,
                 widx: torch.Tensor) -> torch.Tensor:
    """``arr[b, widx[b]] = rows[b]`` where ``0 <= widx[b] < T``, in place,
    for one f32 ``arr [B, T, W]``: ``write_rows`` of one array. Returns
    ``arr``."""
    _check_f32(arr)
    write_rows((arr,), (rows,), widx)
    return arr


def scatter_rows_bulk(arr: torch.Tensor, rows: torch.Tensor,
                      widx: torch.Tensor) -> torch.Tensor:
    """``scatter_rows`` through the bulk-copy unit: ``W`` a multiple of 4,
    ``arr`` and ``rows`` 16-byte aligned, or ``ValueError``."""
    _check_f32(arr)
    if (arr.shape[2] * arr.element_size()) % BULK_ALIGN:
        raise ValueError(f"scatter_rows_bulk copies rows of whole 16-byte units: "
                         f"W must be a multiple of 4, got {arr.shape[2]}")
    write_rows_bulk((arr,), (rows,), widx)
    return arr
