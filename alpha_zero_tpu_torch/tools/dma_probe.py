"""Row-scatter probe: how fast can the card write one row per game lane
into tree arrays? The port's counterpart of the repository's
``tools/dma_probe.py``; ``tools/dma_probe_torch.py`` is its command line.

Two kinds of lines, each variant held bit-equal to its plain version first:

- One f32 array ``[B, T, W]`` (the TPU probe's function), at ``W = a`` and
  ``a`` rounded up to a multiple of 128 (the TPU probe's padded width; the
  bulk kernel runs there only): the dense one-hot blend ``blend_scatter``,
  out of place (it allocates and writes a whole ``[B, T, W]`` every call);
  ``scatter_rows`` (K2) and ``scatter_rows_bulk`` (K3), in place; one
  ``index_copy_`` on the ``[B*T, W]`` view (the library yardstick); the
  plain ``put_rows`` with every lane writing.
- The search's two tree writes as sets (``tree_sets``): the 13 arrays a
  simulation writes when it materializes a node and the 2 it writes when
  it expands one, at go-shaped dtypes (int8 board, int8 or int16 labels
  and liberties, int8/int32 scalars, f32 stats, f32 priors, bool): the
  writer ``write_rows`` (K2, one launch a set) beside the ``put_rows``
  sequence it replaced on the main path, and the launch floor, the writer
  with every ``widx`` at -1 (each warp reads its lane's index and returns).

Every line gives the mean of ``reps`` back-to-back calls (``ms``, the host's
dispatch included). On the card it also gives device times from CUDA-graph
replays (``utils/device.py:graph_ms``): ``graph_ms`` warm in L2 and, for
the sets, ``cold_ms`` with L2 flushed before each call; a set's kernel and
its plain sequence are timed warm in turns (plain, kernel, kernel, plain),
and ``graph_ms`` is the mean of a variant's two turns. The kernels'
``.launches`` counts see neither the captured calls nor the replays.
Inputs come from a generator seeded with 0; ``widx`` is uniform in
``[0, T)``, so every lane writes. Each line gives the bytes the function
must move (each input read once, each output written once) and their time
at the card's memory rate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from alpha_zero_tpu_torch.ops.scatter_kernels import (blend_scatter, put_rows,
                                                      scatter_rows, scatter_rows_bulk,
                                                      write_rows, write_rows_plain)
from alpha_zero_tpu_torch.utils.device import (HBM_BYTES_PER_S, L2_BYTES, card_line,
                                               graph_ms, resolve_device, time_ms)

SETS = ("materialize", "expand")


def row_bytes(batch: int, width: int) -> int:
    """Bytes of one in-place f32 row scatter: the rows read and written
    once, and ``widx``."""
    return 2 * batch * width * 4 + batch * 4


def blend_bytes(batch: int, t: int, width: int) -> int:
    """Bytes of the out-of-place blend: the array read and a new one
    written, the rows and ``widx`` read."""
    return 2 * batch * t * width * 4 + batch * width * 4 + batch * 4


def lane_bytes(rows) -> int:
    """Row bytes of one lane across a set."""
    return sum(r[0].numel() * r.element_size() for r in rows)


def set_bytes(batch: int, rows) -> int:
    """Bytes of one write of a set: every row read and written once, and
    ``widx``."""
    return 2 * batch * lane_bytes(rows) + batch * 4


def tree_sets(batch: int, t: int, a: int, gen: torch.Generator,
              device) -> Dict[str, Tuple[List[torch.Tensor], List[torch.Tensor]]]:
    """``{set: (arrays, rows)}`` with random contents: the 13 arrays of the
    search's materialize write (the 6 ``NodeState`` fields, then
    parent_index, action_from_parent, node_done, node_reward, node_N,
    node_W, node_P) and the 2 of its expand write (child_P, node_expanded)
    for a tree of ``t`` slots and ``a`` actions on an ``isqrt(a)``-wide
    board (labels and liberties int8 up to 11x11, int16 above)."""
    n = math.isqrt(a)
    idt = torch.int8 if n * n <= 127 else torch.int16

    def ints(shape, dtype):
        hi = 100 if dtype == torch.int8 else 30000
        return torch.randint(-hi, hi, shape, generator=gen, device=device, dtype=dtype)

    def f32(shape):
        return torch.randn(shape, generator=gen, device=device)

    def pair(row_shape, make):
        return make((batch, t) + row_shape), make((batch,) + row_shape)

    materialize = [pair((n, n), lambda s: ints(s, torch.int8)),
                   pair((n, n), lambda s: ints(s, idt)),
                   pair((n * n + 1,), lambda s: ints(s, idt)),
                   pair((), lambda s: ints(s, torch.int8)),
                   pair((), lambda s: ints(s, torch.int32)),
                   pair((), lambda s: ints(s, torch.int32))]
    materialize += [pair((), f32) for _ in range(7)]
    expand = [pair((a,), f32),
              pair((), lambda s: torch.randint(0, 2, s, generator=gen,
                                               device=device).bool())]
    return {name: ([x for x, _ in pairs], [r for _, r in pairs])
            for name, pairs in (("materialize", materialize), ("expand", expand))}


def _same_bytes(x: torch.Tensor, y: torch.Tensor) -> bool:
    return torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))


def check_writer(writer, arrays, rows, widx: torch.Tensor) -> None:
    """Raises ``RuntimeError`` unless ``writer`` on copies of ``arrays``
    leaves the same bytes as ``write_rows_plain``; the arrays themselves
    are untouched."""
    got = [x.clone() for x in arrays]
    ref = [x.clone() for x in arrays]
    writer(got, rows, widx)
    write_rows_plain(ref, rows, widx)
    for k, (g, r) in enumerate(zip(got, ref)):
        if not _same_bytes(g, r):
            bad = int((g.view(torch.uint8) != r.view(torch.uint8)).flatten(1).any(1).sum())
            raise RuntimeError(f"{writer.__name__} != write_rows_plain in array {k} "
                               f"({tuple(g.shape)} {g.dtype}), {bad} lanes")


def _single_lines(batch, t, a, reps, dev, gen) -> List[Dict]:
    apad = -(-a // 128) * 128
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
                ("put_rows", lambda: put_rows(arr, bidx, slot, rows, write))]
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
    lines = []
    for w in sorted(inputs):
        for vname, fn in variants(*inputs[w]):
            nbytes = (blend_bytes(batch, t, w) if vname == "blend_scatter"
                      else row_bytes(batch, w))
            lines.append(dict(name=vname, width=w, ms=time_ms(fn, reps, dev),
                              graph_ms=graph_ms(fn, reps) if dev.type == "cuda" else None,
                              bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
    return lines


def _set_lines(batch, t, a, reps, dev, gen) -> List[Dict]:
    widx = torch.randint(0, t, (batch,), generator=gen, device=dev, dtype=torch.int32)
    ragged = widx.clone()
    ragged[::3] = -1
    ragged[1::7] = t
    idle = torch.full_like(widx, -1)
    lines = []
    for set_name, (arrays, rows) in tree_sets(batch, t, a, gen, dev).items():
        for w in (widx, ragged, idle):
            check_writer(write_rows, arrays, rows, w)
        nbytes = set_bytes(batch, rows)
        variants = {"write_rows": lambda: write_rows(arrays, rows, widx),
                    "put_rows": lambda: write_rows_plain(arrays, rows, widx)}
        if set_name == "materialize":
            variants["launch_floor"] = lambda: write_rows(arrays, rows, idle)
        turns = {name: [] for name in variants}
        if dev.type == "cuda":
            for name in ("put_rows", "write_rows", "write_rows", "put_rows"):
                turns[name].append(graph_ms(variants[name], reps))
            if "launch_floor" in variants:
                turns["launch_floor"].append(graph_ms(variants["launch_floor"], reps))
        for name, fn in variants.items():
            cuda = dev.type == "cuda"
            lines.append(dict(
                name=name, set=set_name, arrays=len(arrays), lane_bytes=lane_bytes(rows),
                ms=time_ms(fn, reps, dev),
                graph_ms=sum(turns[name]) / len(turns[name]) if cuda else None,
                graph_turns_ms=turns[name] if cuda else None,
                cold_ms=graph_ms(fn, reps, 2 * L2_BYTES) if cuda else None,
                bytes=0 if name == "launch_floor" else nbytes,
                bound_ms=0.0 if name == "launch_floor" else nbytes / HBM_BYTES_PER_S * 1e3))
    return lines


def run_probe(batch: int = 1024, t: int = 201, a: int = 82, reps: int = 50,
              device="cuda") -> Dict:
    """Checks, then times, every row-scatter variant at ``[batch, t, a]``
    and at the padded width, and the search's two tree-write sets. Raises
    ``RuntimeError`` if a kernel or a yardstick disagrees with its plain
    version in any bit. Returns ``{"device", "batch", "t", "a", "apad",
    "reps", "lines", "sets"}``: each line ``{"name", "width", "ms",
    "graph_ms", "bytes", "bound_ms"}``, each set line ``{"name", "set",
    "arrays", "lane_bytes", "ms", "graph_ms", "graph_turns_ms", "cold_ms",
    "bytes", "bound_ms"}`` (device times None on the CPU); prints them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = _single_lines(batch, t, a, reps, dev, gen)
    sets = _set_lines(batch, t, a, reps, dev, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def us(x):
        return "      n/a" if x is None else f"{x * 1e3:9.3f}"

    card = card_line() if dev.type == "cuda" else "cpu (host clock; no device numbers)"
    apad = -(-a // 128) * 128
    print(f"row-scatter probe B={batch} T={t} A={a} (padded {apad}), mean of {reps} "
          f"calls on {card}; all bit-equal to their plain version. us per call: back "
          f"to back, and graph device time warm (cold: L2 flushed). Bound: bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s.")
    for x in lines:
        print(f"  {x['name']:<18} W={x['width']:<4} {us(x['ms'])} (graph {us(x['graph_ms'])})"
              f"  {x['bytes'] / 1e6:8.3f} MB  bound {us(x['bound_ms'])}")
    for x in sets:
        print(f"  {x['name']:<13} {x['set']:<11} {x['arrays']:>2} arrays "
              f"{x['lane_bytes']:>4} B/lane {us(x['ms'])} (graph {us(x['graph_ms'])}, "
              f"cold {us(x['cold_ms'])})  {x['bytes'] / 1e6:8.3f} MB  bound {us(x['bound_ms'])}")
    return dict(device=card, batch=batch, t=t, a=a, apad=apad, reps=reps, lines=lines,
                sets=sets)
