"""Parity: the port's row-scatter wrappers (K2 ``scatter_rows``, K3
``scatter_rows_bulk``) and their plain version against the TPU kernels they
replace, run by JAX in interpret mode, and against the JAX ``blend_scatter``.

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
                                                      scatter_rows_bulk)
from alpha_zero_tpu_torch.search import mcts
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
    mcts._put_rows(put, torch.arange(b), t_slot.long(), t_rows, torch.from_numpy(write))
    widx = torch.where(torch.from_numpy(write), t_slot, -1)
    assert torch.equal(scatter_rows(t_arr, t_rows, widx), put)


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_rows_bulk"])
def test_wrappers_run_plain_version_on_cpu(name):
    """In place, lanes out of range untouched, and no launch counted."""
    wrapper = getattr(scatter_kernels, name)
    arr, rows, widx = _inputs(37, 17, 12, seed=3, lo=-3, hi=20)
    t_arr, t_rows, t_widx = _torch(arr, rows, widx)
    before = wrapper.launches
    assert wrapper(t_arr, t_rows, t_widx) is t_arr
    assert wrapper.launches == before
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
    names = ["blend_scatter", "scatter_rows", "index_copy_", "_put_rows"]
    assert got == ([(n, 82) for n in names]
                   + [(n, 128) for n in names[:2] + ["scatter_rows_bulk"] + names[2:]])
    for x in out["lines"]:
        w = x["width"]
        expect = (2 * 16 * 9 * w * 4 + 16 * w * 4 + 64 if x["name"] == "blend_scatter"
                  else 2 * 16 * w * 4 + 64)
        assert x["bytes"] == expect
        assert x["bound_ms"] == pytest.approx(expect / 3.35e12 * 1e3)
        assert x["ms"] > 0 and x["graph_ms"] is None  # no device time on the CPU
    assert len(capsys.readouterr().out.splitlines()) == 1 + len(got)
    # go9's tree at B=1024: 1.05 MB for a row scatter at the padded width.
    assert dma_probe.row_bytes(1024, 128) == 1_052_672


def test_probe_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        dma_probe.run_probe(8, 5, 12, reps=1)


def test_time_ms_calls_once_to_warm_up_then_reps_times_on_cpu():
    calls = []
    ms = time_ms(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4 and ms >= 0
