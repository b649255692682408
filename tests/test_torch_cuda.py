"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip without a card. They import only the port, so on a machine with a
card and no JAX they run with the repository's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.tools import dma_probe
from alpha_zero_tpu_torch.tools.dma_probe import check_writer, tree_sets
from alpha_zero_tpu_torch.tools.select_bench import FIELDS, synthetic_trees
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.device import device_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


def _small_setup(board_size, sims, device):
    cfg = config_lib.go9()
    env = dataclasses.replace(cfg.env, board_size=board_size)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=16,
                                  num_fc_units=16, inference_dtype="float32")
    search = dataclasses.replace(cfg.search, num_simulations=sims,
                                 max_new_sims=sims // 2)
    engine = build_engine(env)
    net = build_network(env, net_cfg, device=device, seed=0)
    return engine, net, search, cfg.resign


def _grown_trees(board_size, sims, batch, device):
    """Post-search trees after two self-play moves, on ``device``."""
    engine, net, search, resign = _small_setup(board_size, sims, device)
    step = selfplay.make_selfplay_step(engine, net, search, resign, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    sp = selfplay.init_selfplay_state(engine, batch, gen, -1.0, 0.0,
                                      reuse_num_simulations=sims, device=device)
    for _ in range(2):
        sp, _ = step(sp, gen, -1.0)
    _, trees = mcts.batched_search(
        selfplay.make_eval_fn(net), engine, sp.games, sims, root_noise=True,
        generator=gen, prev_trees=sp.trees, return_trees=True)
    kw = dict(path_cap=min(sims + 1, engine.max_steps + 2),
              c_puct_base=search.c_puct_base, c_puct_init=search.c_puct_init)
    args = (trees.node_N, trees.node_W, trees.node_P, trees.parent_index,
            trees.action_from_parent, trees.node_done, trees.child_P)
    return args, kw


@pytest.mark.parametrize("board_size,sims,batch", [(5, 16, 8), (9, 64, 37)])
def test_select_kernel_bit_equal_to_plain(board_size, sims, batch, cuda_device):
    args, kw = _grown_trees(board_size, sims, batch, cuda_device)
    before = tree_kernels.select_leaf_batched.launches
    out = tree_kernels.select_leaf_batched(*args, **kw)
    ref = tree_kernels.select_leaf_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tree_kernels.select_leaf_batched.launches == before + 1
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)
    assert int(ref[6].max()) >= 2


# (T, A) of the configs' trees, and one whose lane needs more than the
# default 48 KB of shared memory (the kernel's opt-in path).
_GEOMETRIES = {"go9": (201, 82), "gomoku13": (381, 169), "go19_jumbo": (801, 362),
               "t1601": (1601, 362)}


def _synthetic_args(geometry, batch, device, seed=0):
    t, a = _GEOMETRIES[geometry]
    arrays = synthetic_trees(batch, t, a, seed)
    return tuple(torch.from_numpy(arrays[f]).to(device) for f in FIELDS), t


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
@pytest.mark.parametrize("cut", [False, True], ids=["full_path_cap", "cut_path_cap"])
def test_select_kernel_bit_equal_on_synthetic_trees(geometry, cut, cuda_device):
    """Every kind of synthetic lane (chains, ties, ±0.0 priors, a terminal
    child, an unexpanded root, random trees) at the tree shapes of go9,
    gomoku13, go19_jumbo and T=1601, B=37; the cut path_cap stops the
    chains."""
    args, t = _synthetic_args(geometry, 37, cuda_device)
    kw = dict(path_cap=t // 2 if cut else t, c_puct_base=19652.0, c_puct_init=1.25)
    out = tree_kernels.select_leaf_batched(*args, **kw)
    ref = tree_kernels.select_leaf_plain(*args, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)
    assert int(ref[6].max()) == min(kw["path_cap"], t - 3)


def test_select_is_one_kernel_launch_per_call(cuda_device):
    args, t = _synthetic_args("go9", 64, cuda_device)
    kw = dict(path_cap=t, c_puct_base=19652.0, c_puct_init=1.25)
    per_call = device_kernels(lambda: tree_kernels.select_leaf_batched(*args, **kw), 5)
    assert [n for n, _ in per_call.values()] == [1.0], per_call
    assert "select_leaf_kernel" in next(iter(per_call))


def test_select_launches_skip_graph_capture_and_replay(cuda_device):
    """A call under CUDA-graph capture records the kernel and is not
    counted; the replay runs it without the wrapper, and it is right."""
    args, t = _synthetic_args("go9", 37, cuda_device)
    kw = dict(path_cap=t, c_puct_base=19652.0, c_puct_init=1.25)
    select = tree_kernels.select_leaf_batched
    ref = tree_kernels.select_leaf_plain(*args, **kw)
    select(*args, **kw)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = select.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = select(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert select.launches == before
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_select_kernel_rejects_bad_cuda_inputs(cuda_device):
    args, kw = _grown_trees(5, 16, 4, cuda_device)
    before = tree_kernels.select_leaf_batched.launches
    with pytest.raises(TypeError):
        tree_kernels.select_leaf_batched(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        tree_kernels.select_leaf_batched(args[0].cpu(), *args[1:], **kw)
    assert tree_kernels.select_leaf_batched.launches == before


def test_selfplay_step_launches_select_once_per_simulation(cuda_device):
    engine, net, search, resign = _small_setup(5, 16, cuda_device)
    step = selfplay.make_selfplay_step(engine, net, search, resign, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    sp = selfplay.init_selfplay_state(engine, 8, gen, -1.0, 0.0,
                                      reuse_num_simulations=16, device=cuda_device)
    for _ in range(3):
        before = tree_kernels.select_leaf_batched.launches
        sp, out = step(sp, gen, -1.0)
        assert tree_kernels.select_leaf_batched.launches - before == search.max_new_sims
        assert torch.allclose(out.search_pi.sum(-1),
                              torch.ones(8, device=cuda_device), atol=1e-5)


def _scatter_inputs(b, t, w, device, ragged):
    """Normal arr/rows; widx uniform in [0, T), or for a ragged case in
    [-3, T + 3) with -1, T and T + 2 among the first lanes."""
    gen = torch.Generator(device=device).manual_seed(5)
    arr = torch.randn((b, t, w), generator=gen, device=device)
    rows = torch.randn((b, w), generator=gen, device=device)
    lo, hi = (-3, t + 3) if ragged else (0, t)
    widx = torch.randint(lo, hi, (b,), generator=gen, device=device).to(torch.int32)
    if ragged:
        widx[:3] = torch.tensor([-1, t, t + 2], dtype=torch.int32)
    return arr, rows, widx


# The kernel each single-array wrapper launches, and so the count it adds to.
_COUNTER = {"scatter_rows": scatter_kernels.write_rows,
            "scatter_rows_bulk": scatter_kernels.write_rows_bulk}


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_rows_bulk"])
@pytest.mark.parametrize("b,t,w,ragged", [(1024, 201, 128, False), (37, 17, 12, True)])
def test_scatter_kernel_bit_equal_to_plain(name, b, t, w, ragged, cuda_device):
    """go9's tree at the padded width, and a ragged batch whose widx runs
    out of range on both sides."""
    kernel = getattr(scatter_kernels, name)
    arr, rows, widx = _scatter_inputs(b, t, w, cuda_device, ragged)
    ref = scatter_kernels.blend_scatter(arr, rows, widx)
    before = _COUNTER[name].launches
    assert kernel(arr, rows, widx) is arr
    torch.cuda.synchronize()
    assert _COUNTER[name].launches == before + 1
    assert torch.equal(arr, ref)


def test_scatter_bulk_rejects_unaligned_rows(cuda_device):
    bulk = scatter_kernels.scatter_rows_bulk
    before = scatter_kernels.write_rows_bulk.launches
    arr, rows, widx = _scatter_inputs(8, 5, 82, cuda_device, ragged=True)
    with pytest.raises(ValueError, match="multiple of 4"):
        bulk(arr, rows, widx)
    arr, rows, widx = _scatter_inputs(8, 5, 128, cuda_device, ragged=True)
    view = torch.zeros(arr.numel() + 1, device=cuda_device)[1:].view(arr.shape).copy_(arr)
    with pytest.raises(ValueError, match="aligned"):
        bulk(view, rows, widx)
    assert scatter_kernels.write_rows_bulk.launches == before
    # K2 takes the misaligned view.
    scatter_kernels.scatter_rows(view, rows, widx)
    assert torch.equal(view, scatter_kernels.blend_scatter(arr, rows, widx))


def test_scatter_probe_runs_on_the_card(cuda_device):
    out = dma_probe.run_probe(64, 9, 82, reps=2, device=cuda_device)
    assert len(out["lines"]) == 9 and len(out["sets"]) == 5
    assert all(x["ms"] > 0 and x["graph_ms"] > 0 for x in out["lines"] + out["sets"])


def test_scatter_launches_skip_graph_capture_and_replay(cuda_device):
    """A call under CUDA-graph capture records the kernel and is not
    counted; the replay runs it without the wrapper, and it writes."""
    arr, rows, widx = _scatter_inputs(37, 17, 12, cuda_device, ragged=True)
    ref = scatter_kernels.blend_scatter(arr, rows, widx)
    kernel = scatter_kernels.scatter_rows
    kernel(arr.clone(), rows, widx)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = scatter_kernels.write_rows.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernel(arr, rows, widx)
    graph.replay()
    torch.cuda.synchronize()
    assert scatter_kernels.write_rows.launches == before
    assert torch.equal(arr, ref)


def _ragged_widx(b, t, device, seed=3):
    """widx in [-3, T + 3) with -1, T and T + 2 among the first lanes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    widx = torch.randint(-3, t + 3, (b,), generator=gen, device=device).to(torch.int32)
    widx[:3] = torch.tensor([-1, t, t + 2], dtype=torch.int32)
    return widx


def _misaligned_byte_set(b, t, device):
    """int8 and bool arrays whose rows (1, 3, 17 and 33 bytes) start at odd
    addresses: views one byte into their storage, rows likewise."""
    gen = torch.Generator(device=device).manual_seed(4)
    arrays, rows = [], []
    for row_shape, dtype in (((), torch.int8), ((3,), torch.int8), ((17,), torch.int8),
                             ((33,), torch.int8), ((5,), torch.bool)):
        out = []
        for shape in ((b, t) + row_shape, (b,) + row_shape):
            n = 1
            for d in shape:
                n *= d
            base = torch.randint(-100, 100, (n + 1,), generator=gen, device=device)
            out.append(base.to(dtype)[1:].view(shape))
        arrays.append(out[0])
        rows.append(out[1])
    assert arrays[1].data_ptr() % 2 == 1
    return arrays, rows


def _writer_case(case, device):
    """(arrays, rows, widx) of a writer check."""
    gen = torch.Generator(device=device).manual_seed(2)
    if case in ("go9_materialize", "go9_expand"):
        arrays, rows = tree_sets(1024, 201, 82, gen, device)[case.split("_")[1]]
        return arrays, rows, _ragged_widx(1024, 201, device)
    if case == "go19_int16":  # labels 722 B, group_libs 724 B, child_P 1448 B
        sets = tree_sets(64, 101, 362, gen, device)
        arrays, rows = sets["materialize"]
        assert arrays[1].dtype == torch.int16 and rows[2][0].numel() * 2 == 724
        return (arrays + sets["expand"][0], rows + sets["expand"][1],
                _ragged_widx(64, 101, device))
    if case == "misaligned_bytes":
        arrays, rows = _misaligned_byte_set(64, 9, device)
        return arrays, rows, _ragged_widx(64, 9, device)
    if case == "ragged_b37":
        arrays, rows = tree_sets(37, 17, 26, gen, device)["materialize"]
        return arrays, rows, _ragged_widx(37, 17, device)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["go9_materialize", "go9_expand", "go19_int16",
                                  "misaligned_bytes", "ragged_b37"])
def test_writer_bit_equal_to_plain(case, cuda_device):
    arrays, rows, widx = _writer_case(case, cuda_device)
    before = scatter_kernels.write_rows.launches
    check_writer(scatter_kernels.write_rows, arrays, rows, widx)
    torch.cuda.synchronize()
    assert scatter_kernels.write_rows.launches == before + 1
    check_writer(scatter_kernels.write_rows, arrays, rows, torch.full_like(widx, -1))


def test_writer_is_one_kernel_launch_per_call(cuda_device):
    arrays, rows, widx = _writer_case("go9_materialize", cuda_device)
    per_call = device_kernels(lambda: scatter_kernels.write_rows(arrays, rows, widx), 5)
    assert [n for n, _ in per_call.values()] == [1.0], per_call
    assert "write_rows_kernel" in next(iter(per_call))


def test_writer_launches_skip_graph_capture_and_replay(cuda_device):
    arrays, rows, widx = _writer_case("go9_expand", cuda_device)
    ref = [x.clone() for x in arrays]
    scatter_kernels.write_rows_plain(ref, rows, widx)
    writer = scatter_kernels.write_rows
    writer([x.clone() for x in arrays], rows, widx)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = writer.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        writer(arrays, rows, widx)
    graph.replay()
    torch.cuda.synchronize()
    assert writer.launches == before
    for got, r in zip(arrays, ref):
        assert torch.equal(got, r)


def test_selfplay_step_launches_writer_twice_per_simulation(cuda_device):
    engine, net, search, resign = _small_setup(9, 16, cuda_device)
    step = selfplay.make_selfplay_step(engine, net, search, resign, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    sp = selfplay.init_selfplay_state(engine, 8, gen, -1.0, 0.0,
                                      reuse_num_simulations=16, device=cuda_device)
    for _ in range(2):
        before = scatter_kernels.write_rows.launches
        sp, _ = step(sp, gen, -1.0)
        assert scatter_kernels.write_rows.launches - before == 2 * search.max_new_sims


def test_bulk_writer_bit_equal_on_16_byte_rows(cuda_device):
    """K3 on a set of rows made of whole 16-byte units in four dtypes."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    arrays, rows = [], []
    for row_shape, dtype in (((128,), torch.float32), ((16,), torch.int8),
                             ((8,), torch.int16), ((4, 4), torch.int32)):
        for shape, out in (((37, 17) + row_shape, arrays), ((37,) + row_shape, rows)):
            out.append(torch.randint(-100, 100, shape, generator=gen,
                                     device=cuda_device).to(dtype))
    widx = _ragged_widx(37, 17, cuda_device)
    before = scatter_kernels.write_rows_bulk.launches
    check_writer(scatter_kernels.write_rows_bulk, arrays, rows, widx)
    torch.cuda.synchronize()
    assert scatter_kernels.write_rows_bulk.launches == before + 1
    with pytest.raises(ValueError, match="16-byte"):
        scatter_kernels.write_rows_bulk([arrays[1][:, :, :1].contiguous()],
                                        [rows[1][:, :1].contiguous()], widx)
