"""Row-scatter probe: how fast can the card write one row per game lane
into a ``[B, T, W]`` tree array? The port's counterpart of the repository's
``tools/dma_probe.py``; ``tools/dma_probe_torch.py`` is its command line.

The search writes each new node's rows (``search/mcts.py:_put_rows``) into
arrays of that shape every simulation. This probe holds the two row-scatter
kernels (``ops/scatter_kernels.py``) bit-equal to the dense blend, then
times, as the mean of ``reps`` back-to-back calls:

- the dense one-hot blend ``blend_scatter``, out of place: it allocates and
  writes a whole new ``[B, T, W]`` array every call;
- ``scatter_rows`` (K2) and ``scatter_rows_bulk`` (K3), in place;
- one ``index_copy_`` on the ``[B*T, W]`` view (the library yardstick);
- the search's own ``_put_rows`` with every lane writing.

On the card each variant gets a second time, ``graph_ms``: the same
``reps`` calls captured in one CUDA graph and replayed
(``utils/device.py:graph_ms``). It leaves out the host's dispatch of each
call, so it is the device time, and the gap between the two times is host
work. The kernels' ``.launches`` counts see neither the captured calls nor
the replays.

Widths: ``a`` and ``a`` rounded up to a multiple of 128 (the padded width
of the TPU probe, ``tools/dma_probe.py``); the bulk kernel runs on the
padded width only. Inputs follow that probe: normal arrays and rows, ``widx``
uniform in ``[0, T)``, from a seeded generator. The in-place calls write the
same rows into the same array every time, with no copy inside the timed
loop, and find the rows warm in L2. Each line gives the bytes the function
must move (each input read once, each output written once) and the time
that takes at the card's memory rate.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from alpha_zero_tpu_torch.ops.scatter_kernels import (blend_scatter, scatter_rows,
                                                      scatter_rows_bulk)
from alpha_zero_tpu_torch.search.mcts import _put_rows
from alpha_zero_tpu_torch.utils.device import (HBM_BYTES_PER_S, card_line, graph_ms,
                                               resolve_device, time_ms)


def row_bytes(batch: int, width: int) -> int:
    """Bytes of one in-place row scatter: the rows read and written once,
    and ``widx``."""
    return 2 * batch * width * 4 + batch * 4


def blend_bytes(batch: int, t: int, width: int) -> int:
    """Bytes of the out-of-place blend: the array read and a new one
    written, the rows and ``widx`` read."""
    return 2 * batch * t * width * 4 + batch * width * 4 + batch * 4


def run_probe(batch: int = 1024, t: int = 201, a: int = 82, reps: int = 50,
              device="cuda") -> Dict:
    """Checks, then times, every row-scatter variant at ``[batch, t, a]``
    and at the padded width. Raises ``RuntimeError`` if a kernel or a
    yardstick disagrees with ``blend_scatter`` in any bit. Returns
    ``{"device", "batch", "t", "a", "apad", "reps", "lines"}``, each line
    ``{"name", "width", "ms", "graph_ms", "bytes", "bound_ms"}`` (``graph_ms``
    None on the CPU), and prints them. Inputs come from a generator seeded
    with 0."""
    dev = resolve_device(device)
    apad = -(-a // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(0)
    widx = torch.randint(0, t, (batch,), generator=gen, device=dev, dtype=torch.int32)
    flat_idx = torch.arange(batch, device=dev) * t + widx.long()
    bidx = torch.arange(batch, device=dev)
    slot = widx.long()
    write = torch.ones(batch, dtype=torch.bool, device=dev)
    inputs = {w: (torch.randn((batch, t, w), generator=gen, device=dev),
                  torch.randn((batch, w), generator=gen, device=dev))
              for w in sorted({a, apad})}

    def variants(arr, rows):
        w = arr.shape[2]
        out = [("blend_scatter", lambda: blend_scatter(arr, rows, widx)),
               ("scatter_rows", lambda: scatter_rows(arr, rows, widx))]
        if w % 4 == 0:
            out.append(("scatter_rows_bulk", lambda: scatter_rows_bulk(arr, rows, widx)))
        out += [("index_copy_", lambda: arr.view(batch * t, w).index_copy_(0, flat_idx, rows)),
                ("_put_rows", lambda: _put_rows(arr, bidx, slot, rows, write))]
        return out

    # Correctness first: every in-place variant on a copy, against the blend.
    for w, (arr, rows) in inputs.items():
        ref = blend_scatter(arr, rows, widx)
        copy = arr.clone()
        for name, fn in variants(copy, rows)[1:]:
            copy.copy_(arr)
            fn()
            if not torch.equal(copy, ref):
                bad = int((copy != ref).flatten(1).any(dim=1).sum())
                raise RuntimeError(f"{name} at W={w} != blend_scatter in {bad}/{batch} lanes")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    card = card_line() if dev.type == "cuda" else "cpu (host clock; no device numbers)"
    print(f"row-scatter probe B={batch} T={t} A={a} (padded {apad}), mean of {reps} "
          f"back-to-back calls on {card}; all bit-equal to blend_scatter. Rows warm "
          f"in L2; the blend allocates its [B, T, W] output every call. Bound: bytes "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s.")
    lines: List[Dict] = []
    for w in sorted(inputs):
        for vname, fn in variants(*inputs[w]):
            nbytes = (blend_bytes(batch, t, w) if vname == "blend_scatter"
                      else row_bytes(batch, w))
            ms = time_ms(fn, reps, dev)
            g_ms = graph_ms(fn, reps) if dev.type == "cuda" else None
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            lines.append(dict(name=vname, width=w, ms=ms, graph_ms=g_ms,
                              bytes=nbytes, bound_ms=bound_ms))
            graph = "" if g_ms is None else f" (graph {g_ms * 1e3:9.3f})"
            print(f"  {vname:<18} W={w:<4} {ms * 1e3:11.3f} us/call{graph}  "
                  f"{nbytes / 1e6:10.3f} MB  bound {bound_ms * 1e3:9.3f} us")
    return dict(device=card, batch=batch, t=t, a=a, apad=apad, reps=reps, lines=lines)
