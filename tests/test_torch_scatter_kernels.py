"""Parity: the port's row-scatter wrappers (K2 ``write_rows`` and its
single-array case ``scatter_rows``, K3 ``write_rows_bulk`` and
``scatter_rows_bulk``) and their plain versions against the TPU kernels they
replace, run by JAX in interpret mode, against the JAX ``blend_scatter``,
and against JAX's own row scatter ``arr.at[bidx, widx].set(rows,
mode="drop", unique_indices=True)``, the tree write of the JAX package's
``_materialize_scatter`` / ``_expand_backup_scatter``.

The TPU kernels are copied verbatim from ``tools/dma_probe.py:44-131``
(its ``B``, ``T``, ``A`` and ``BLK`` made parameters, ``interpret=True``
added), since that file is a script and defines them inside ``main``. The
CUDA kernels themselves are tested on the card by ``tests/test_torch_cuda.py``.
Tolerance: exact. The function only moves bytes, so every output must be
equal bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from alpha_zero_tpu_torch.ops import scatter_kernels
from alpha_zero_tpu_torch.ops.scatter_kernels import (blend_scatter, scatter_rows,
                                                      scatter_rows_bulk, write_rows,
                                                      write_rows_bulk, write_rows_plain)
from alpha_zero_tpu_torch.tools import dma_probe
from alpha_zero_tpu_torch.utils.device import time_ms


@functools.lru_cache(maxsize=None)
def _tpu_kernels(B, T, A, BLK):
    """``dma_scatter`` and ``dma_scatter_overlap`` of ``tools/dma_probe.py``
    (lines 42-131), in interpret mode."""
    Apad = -(-A // 128) * 128

    def scatter_kernel(widx_ref, rows_ref, arr_ref, out_ref, sem):
        del arr_ref  # aliased to out_ref; writes go through out_ref
        i = pl.program_id(0)

        def put(j, _):
            w = widx_ref[i * BLK + j]

            @pl.when(w >= 0)
            def _():
                dma = pltpu.make_async_copy(
                    rows_ref.at[j], out_ref.at[i * BLK + j, pl.ds(w, 1), 0], sem)
                dma.start()
                dma.wait()

            return 0

        jax.lax.fori_loop(0, BLK, put, 0)

    @jax.jit
    def dma_scatter(arr, rows, widx):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(B // BLK,),
            in_specs=[
                pl.BlockSpec((BLK, 1, Apad), lambda i, w: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.ANY),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA(())],
        )
        return pl.pallas_call(
            scatter_kernel,
            grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((B, T, 1, Apad), jnp.float32),
            input_output_aliases={2: 0},
            compiler_params=pltpu.CompilerParams(has_side_effects=True),
            interpret=True,
        )(widx, rows.reshape(B, 1, Apad), arr.reshape(B, T, 1, Apad)).reshape(B, T, Apad)

    def scatter_kernel_overlap(widx_ref, rows_ref, arr_ref, out_ref, sems):
        del arr_ref
        i = pl.program_id(0)

        def start(j, _):
            w = widx_ref[i * BLK + j]

            @pl.when(w >= 0)
            def _():
                pltpu.make_async_copy(
                    rows_ref.at[j], out_ref.at[i * BLK + j, pl.ds(w, 1), 0],
                    sems.at[j]).start()

            return 0

        def wait(j, _):
            w = widx_ref[i * BLK + j]

            @pl.when(w >= 0)
            def _():
                pltpu.make_async_copy(
                    rows_ref.at[j], out_ref.at[i * BLK + j, pl.ds(w, 1), 0],
                    sems.at[j]).wait()

            return 0

        jax.lax.fori_loop(0, BLK, start, 0)
        jax.lax.fori_loop(0, BLK, wait, 0)

    @jax.jit
    def dma_scatter_overlap(arr, rows, widx):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(B // BLK,),
            in_specs=[
                pl.BlockSpec((BLK, 1, Apad), lambda i, w: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.ANY),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA((BLK,))],
        )
        return pl.pallas_call(
            scatter_kernel_overlap,
            grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((B, T, 1, Apad), jnp.float32),
            input_output_aliases={2: 0},
            compiler_params=pltpu.CompilerParams(has_side_effects=True),
            interpret=True,
        )(widx, rows.reshape(B, 1, Apad), arr.reshape(B, T, 1, Apad)).reshape(B, T, Apad)

    return {"scatter_rows": dma_scatter, "scatter_rows_bulk": dma_scatter_overlap}


def _jax_blend_scatter(arr, rows, widx, T):
    """The body of ``tools/dma_probe.py:blend_scatter`` (lines 133-137)."""
    t_iota = jnp.arange(T, dtype=jnp.int32)
    oh = (t_iota[None, :] == widx[:, None])[:, :, None]
    return jnp.where(oh, rows[:, None, :], arr)


def _inputs(b, t, w, seed, lo=-1, hi=None):
    """Seeded normal ``arr``/``rows`` and ``widx`` uniform in ``[lo, hi)``
    (default ``[-1, t)``), with lane 0 writing nothing."""
    rng = np.random.RandomState(seed)
    arr = rng.standard_normal((b, t, w)).astype(np.float32)
    rows = rng.standard_normal((b, w)).astype(np.float32)
    widx = rng.randint(lo, t if hi is None else hi, size=b).astype(np.int32)
    widx[0] = -1
    return arr, rows, widx


def _torch(*arrays):
    return tuple(torch.from_numpy(x.copy()) for x in arrays)


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_rows_bulk"])
@pytest.mark.parametrize("b,t,a,blk", [(8, 5, 128, 4), (16, 9, 256, 8)])
def test_port_matches_tpu_kernel_in_interpret_mode(name, b, t, a, blk):
    arr, rows, widx = _inputs(b, t, a, seed=b)
    ref = np.asarray(_tpu_kernels(b, t, a, blk)[name](arr, rows, widx))
    t_arr, t_rows, t_widx = _torch(arr, rows, widx)
    out = getattr(scatter_kernels, name)(t_arr, t_rows, t_widx)
    assert out is t_arr
    np.testing.assert_array_equal(ref, out.numpy())
    written = widx >= 0
    assert 0 < written.sum() < b
    np.testing.assert_array_equal(ref[written, widx[written]], rows[written])


@pytest.mark.parametrize("b,t,w", [(64, 201, 82), (37, 17, 12)])
def test_blend_matches_jax_blend(b, t, w):
    """At go9's real width and at a ragged batch, with lanes whose ``widx``
    is -1 or beyond the last slot."""
    arr, rows, widx = _inputs(b, t, w, seed=w, lo=-3, hi=t + 3)
    ref = np.asarray(_jax_blend_scatter(arr, rows, widx, t))
    np.testing.assert_array_equal(ref, blend_scatter(*_torch(arr, rows, widx)).numpy())
    assert (widx >= t).any()


@pytest.mark.parametrize("b,t,w", [(16, 9, 82), (37, 17, 12)])
def test_put_rows_equals_scatter_rows(b, t, w):
    """The search's row write is K2's function with ``widx = where(write,
    slot, -1)``."""
    arr, rows, slot = _inputs(b, t, w, seed=7, lo=0)
    slot[0] = t - 1  # a slot, not the -1 that _inputs puts in lane 0
    write = np.random.RandomState(8).rand(b) < 0.6
    assert write.any() and not write.all()
    t_arr, t_rows, t_slot = _torch(arr, rows, slot)
    put = t_arr.clone()
    scatter_kernels.put_rows(put, torch.arange(b), t_slot.long(), t_rows,
                             torch.from_numpy(write))
    widx = torch.where(torch.from_numpy(write), t_slot, -1)
    assert torch.equal(scatter_rows(t_arr, t_rows, widx), put)


# The kernel each single-array wrapper launches, and so the count it adds to.
_COUNTER = {"scatter_rows": write_rows, "scatter_rows_bulk": write_rows_bulk}


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_rows_bulk"])
def test_wrappers_run_plain_version_on_cpu(name):
    """In place, lanes out of range untouched, and no launch counted."""
    wrapper = getattr(scatter_kernels, name)
    arr, rows, widx = _inputs(37, 17, 12, seed=3, lo=-3, hi=20)
    t_arr, t_rows, t_widx = _torch(arr, rows, widx)
    before = _COUNTER[name].launches
    assert wrapper(t_arr, t_rows, t_widx) is t_arr
    assert _COUNTER[name].launches == before
    np.testing.assert_array_equal(t_arr.numpy(), _jax_blend_scatter(arr, rows, widx, 17))
    dead = (widx < 0) | (widx >= 17)
    assert dead.any()
    np.testing.assert_array_equal(t_arr.numpy()[dead], arr[dead])
    empty = torch.zeros((0, 17, 12))
    assert wrapper(empty, torch.zeros((0, 12)), torch.zeros(0, dtype=torch.int32)) is empty


def _misaligned(arr):
    """A contiguous copy of ``arr`` that starts 4 bytes into its storage."""
    base = torch.zeros(arr.numel() + 1)
    view = base[1:].view(arr.shape)
    return view.copy_(arr)


_BAD_INPUTS = {
    "arr_float64": (TypeError, lambda a, r, w: (a.double(), r, w)),
    "rows_float64": (TypeError, lambda a, r, w: (a, r.double(), w)),
    "widx_int64": (TypeError, lambda a, r, w: (a, r, w.long())),
    "arr_2d": (ValueError, lambda a, r, w: (a[:, 0], r, w)),
    "rows_wrong_width": (ValueError, lambda a, r, w: (a, r[:, :-4], w)),
    "widx_wrong_batch": (ValueError, lambda a, r, w: (a, r, w[:-1])),
    "rows_on_meta": (ValueError, lambda a, r, w: (a, r.to("meta"), w)),
    "arr_not_contiguous": (ValueError,
                           lambda a, r, w: (a.transpose(0, 1).contiguous().transpose(0, 1),
                                            r, w)),
    "all_on_meta": (ValueError, lambda a, r, w: (a.to("meta"), r.to("meta"), w.to("meta"))),
}


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_rows_bulk"])
@pytest.mark.parametrize("case", sorted(_BAD_INPUTS))
def test_wrappers_reject_bad_inputs(name, case):
    error, make = _BAD_INPUTS[case]
    args = make(*_torch(*_inputs(8, 5, 12, seed=1)))
    with pytest.raises(error):
        getattr(scatter_kernels, name)(*args)


def test_bulk_wrapper_rejects_unaligned_rows():
    """K3 needs W % 4 == 0 and 16-byte-aligned data; K2 takes both."""
    arr, rows, widx = _torch(*_inputs(8, 5, 82, seed=2))
    with pytest.raises(ValueError, match="multiple of 4"):
        scatter_rows_bulk(arr, rows, widx)
    arr, rows, widx = _torch(*_inputs(8, 5, 128, seed=2))
    view = _misaligned(arr)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned"):
        scatter_rows_bulk(view, rows, widx)
    with pytest.raises(ValueError, match="aligned"):
        scatter_rows_bulk(arr, _misaligned(rows), widx)
    assert torch.equal(scatter_rows(view, rows, widx), blend_scatter(arr, rows, widx))


def test_probe_checks_and_times_every_variant_on_cpu(capsys):
    out = dma_probe.run_probe(16, 9, 82, reps=1, device="cpu")
    assert out["apad"] == 128 and out["device"].startswith("cpu")
    got = [(x["name"], x["width"]) for x in out["lines"]]
    names = ["blend_scatter", "scatter_rows", "index_copy_", "put_rows"]
    assert got == ([(n, 82) for n in names]
                   + [(n, 128) for n in names[:2] + ["scatter_rows_bulk"] + names[2:]])
    for x in out["lines"]:
        w = x["width"]
        expect = (2 * 16 * 9 * w * 4 + 16 * w * 4 + 64 if x["name"] == "blend_scatter"
                  else 2 * 16 * w * 4 + 64)
        assert x["bytes"] == expect
        assert x["bound_ms"] == pytest.approx(expect / 3.35e12 * 1e3)
        assert x["ms"] > 0 and x["graph_ms"] is None  # no device time on the CPU
    sets = [(x["name"], x["set"], x["arrays"], x["lane_bytes"]) for x in out["sets"]]
    assert sets == [("write_rows", "materialize", 13, 281), ("put_rows", "materialize", 13, 281),
                    ("launch_floor", "materialize", 13, 281), ("write_rows", "expand", 2, 329),
                    ("put_rows", "expand", 2, 329)]
    for x in out["sets"]:
        expect = 0 if x["name"] == "launch_floor" else 2 * 16 * x["lane_bytes"] + 64
        assert x["bytes"] == expect
        assert x["ms"] > 0 and x["graph_ms"] is None and x["cold_ms"] is None
    assert len(capsys.readouterr().out.splitlines()) == 1 + len(got) + len(sets)
    # go9's tree at B=1024: 1.05 MB for a row scatter at the padded width,
    # 0.58 MB for the materialize set and 0.68 MB for the expand set.
    assert dma_probe.row_bytes(1024, 128) == 1_052_672
    assert [x["bytes"] for x in dma_probe.run_probe(1024, 3, 82, reps=1, device="cpu")["sets"]
            if x["name"] == "write_rows"] == [579_584, 677_888]


def test_probe_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        dma_probe.run_probe(8, 5, 12, reps=1)


def test_time_ms_calls_once_to_warm_up_then_reps_times_on_cpu():
    calls = []
    ms = time_ms(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4 and ms >= 0


# ---------------------------------------------------------------------------
# The tree-row writer: N arrays of any dtype, one widx
# ---------------------------------------------------------------------------

# (row shape, numpy dtype) of each array kind a tree write holds.
_KINDS = [((), np.int8), ((3, 3), np.int8), ((10,), np.int16), ((), np.int32),
          ((), np.float32), ((7,), np.float32), ((), np.bool_), ((4,), np.bool_)]


def _set(n, b, t, seed, kinds=_KINDS):
    """``n`` arrays ``[b, t, *row]`` cycling through ``kinds``, their rows,
    and a ragged ``widx`` in ``[-3, t + 3)`` with -1, T and T + 2 among its
    first lanes; numpy, from ``seed``."""
    rng = np.random.RandomState(seed)
    arrays, rows = [], []
    for k in range(n):
        row_shape, dtype = kinds[k % len(kinds)]
        for shape, out in (((b, t) + row_shape, arrays), ((b,) + row_shape, rows)):
            if dtype == np.bool_:
                out.append(rng.rand(*shape) < 0.5)
            elif dtype == np.float32:
                out.append(rng.standard_normal(shape).astype(np.float32))
            else:
                out.append(rng.randint(-100, 100, size=shape).astype(dtype))
    widx = rng.randint(-3, t + 3, size=b).astype(np.int32)
    widx[:3] = [-1, t, t + 2]
    return arrays, rows, widx


def _jax_put_rows(arr, rows, widx, t):
    """The JAX package's tree write (``search/mcts.py:_materialize_scatter``
    ``put_rows``). JAX wraps negative indices before it drops out-of-range
    ones, so the lanes that write nothing get T, the package's own drop
    index."""
    bidx = jnp.arange(arr.shape[0], dtype=jnp.int32)
    drop = jnp.where((widx >= 0) & (widx < t), widx, t)
    return np.asarray(jnp.asarray(arr).at[bidx, drop].set(
        jnp.asarray(rows), mode="drop", unique_indices=True))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 15])
def test_plain_writer_matches_jax_row_scatter(n):
    """int8, int16, int32, f32 and bool rows, ragged widx; exact."""
    arrays, rows, widx = _set(n, 11, 6, seed=n)
    t_arrays = [torch.from_numpy(a.copy()) for a in arrays]
    write_rows_plain(t_arrays, [torch.from_numpy(r) for r in rows], torch.from_numpy(widx))
    for a, r, got in zip(arrays, rows, t_arrays):
        np.testing.assert_array_equal(_jax_put_rows(a, r, widx, 6), got.numpy())
    if n >= 8:
        assert {a.dtype for a in arrays} == {np.dtype(x) for x in (
            np.int8, np.int16, np.int32, np.float32, np.bool_)}
    assert (widx < 0).any() and (widx >= 6).any() and ((widx >= 0) & (widx < 6)).any()


@pytest.mark.parametrize("n", [1, 8, 16])
def test_writer_runs_plain_version_on_cpu(n):
    """In place, the plain writer's bytes, and no launch counted."""
    arrays, rows, widx = _set(n, 9, 5, seed=20 + n)
    got = [torch.from_numpy(a.copy()) for a in arrays]
    ref = [torch.from_numpy(a.copy()) for a in arrays]
    t_rows = [torch.from_numpy(r) for r in rows]
    before = write_rows.launches
    assert write_rows(got, t_rows, torch.from_numpy(widx)) is None
    assert write_rows.launches == before
    write_rows_plain(ref, t_rows, torch.from_numpy(widx))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert any(not np.array_equal(g.numpy(), a) for g, a in zip(got, arrays))


# Rows of whole 16-byte units, which the bulk writer also takes.
_UNIT_KINDS = [((16,), np.int8), ((3, 8), np.int16), ((4,), np.float32)]


def _bad_set(case, kinds):
    """A valid three-array set, spoilt as ``case`` says."""
    arrays, rows, widx = _set(3, 8, 5, seed=4, kinds=kinds)
    arrays = [torch.from_numpy(a) for a in arrays]
    rows = [torch.from_numpy(r) for r in rows]
    widx = torch.from_numpy(widx)
    if case == "rows_dtype":
        rows[1] = rows[1].to(torch.float64)
    elif case == "arr_not_contiguous":
        arrays[1] = arrays[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "rows_not_contiguous":
        rows[1] = rows[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "arr_wrong_batch":
        arrays[2] = arrays[2][:-1]
    elif case == "rows_wrong_batch":
        rows[2] = rows[2][:-1]
    elif case == "rows_wrong_row_shape":
        rows[1] = rows[1][:, :2]
    elif case == "widx_int64":
        widx = widx.long()
    elif case == "mixed_devices":
        rows[0] = rows[0].to("meta")
    elif case == "too_many_arrays":
        arrays, rows = arrays * 6, rows * 6  # 18 > MAX_ARRAYS
    elif case == "no_arrays":
        arrays, rows = [], []
    elif case == "rows_missing":
        rows = rows[:-1]
    return arrays, rows, widx


_BAD_SETS = {"rows_dtype": TypeError, "widx_int64": TypeError,
             **{c: ValueError for c in ("arr_not_contiguous", "rows_not_contiguous",
                                        "arr_wrong_batch", "rows_wrong_batch",
                                        "rows_wrong_row_shape", "mixed_devices",
                                        "too_many_arrays", "no_arrays", "rows_missing")}}


@pytest.mark.parametrize("writer", [write_rows, write_rows_bulk],
                         ids=["write_rows", "write_rows_bulk"])
@pytest.mark.parametrize("case", sorted(_BAD_SETS))
def test_writers_reject_bad_sets(writer, case):
    kinds = _UNIT_KINDS if writer is write_rows_bulk else _KINDS
    writer(*_bad_set("valid", kinds))
    with pytest.raises(_BAD_SETS[case]):
        writer(*_bad_set(case, kinds))


def test_bulk_writer_takes_16_byte_rows_only():
    """K3 rejects go9's 81-byte board row and misaligned data; it takes
    rows of whole 16-byte units in any dtype, and so does K2."""
    rng = np.random.RandomState(5)
    board = torch.from_numpy(rng.randint(-2, 2, size=(8, 5, 9, 9)).astype(np.int8))
    widx = torch.from_numpy(rng.randint(-1, 5, size=8).astype(np.int32))
    with pytest.raises(ValueError, match="81-byte rows"):
        write_rows_bulk([board], [board[:, 0].contiguous()], widx)
    units = [torch.from_numpy(rng.randint(-9, 9, size=(8, 5) + shape).astype(dtype))
             for shape, dtype in (((16,), np.int8), ((8,), np.int16), ((4, 4), np.float32))]
    rows = [u[:, 1].contiguous() for u in units]
    ref = [u.clone() for u in units]
    write_rows_plain(ref, rows, widx)
    with pytest.raises(ValueError, match="aligned"):
        write_rows_bulk([_misaligned(units[2])], [rows[2]], widx)
    got = [u.clone() for u in units]
    write_rows_bulk(got, rows, widx)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got = [u.clone() for u in units]
    write_rows(got, rows, widx)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_tree_sets_have_the_search_row_widths():
    """The probe's go9 and go19 sets: 281 and 329 bytes a lane at go9; int16
    labels (722 B) and liberties (724 B) at go19."""
    gen = torch.Generator().manual_seed(0)
    go9 = dma_probe.tree_sets(4, 3, 82, gen, "cpu")
    assert [dma_probe.lane_bytes(go9[s][1]) for s in ("materialize", "expand")] == [281, 329]
    assert [a.dtype for a in go9["materialize"][0][:6]] == [
        torch.int8, torch.int8, torch.int8, torch.int8, torch.int32, torch.int32]
    go19 = dma_probe.tree_sets(4, 3, 362, gen, "cpu")
    widths = [r[0].numel() * r.element_size() for r in go19["materialize"][1][:3]]
    assert widths == [361, 722, 724]
    assert dma_probe.lane_bytes(go19["expand"][1]) == 1449
