"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip without a card. They import only the port, so on a machine with a
card and no JAX they run with the repository's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import dataclasses

import pytest
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.tools import dma_probe, select_bench
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


@pytest.mark.parametrize("batch", [1, 2])
def test_select_kernel_bit_equal_at_one_and_two_lanes(batch, cuda_device):
    """B=1 and B=2, the batches of the eval game, the host-env agent and
    the lockstep evaluator's games: the deepest lanes of grown go9-shaped
    trees, cut out as trees of their own."""
    args, kw = _grown_trees(9, 64, 37, cuda_device)
    depth = tree_kernels.select_leaf_plain(*args, **kw)[6]
    lanes = torch.argsort(depth, descending=True, stable=True)[:batch]
    args = tuple(a[lanes].contiguous() for a in args)
    before = tree_kernels.select_leaf_batched.launches
    out = tree_kernels.select_leaf_batched(*args, **kw)
    ref = tree_kernels.select_leaf_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tree_kernels.select_leaf_batched.launches == before + 1
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)
    assert int(ref[6].min()) >= 2


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


@pytest.mark.parametrize("batch", [1, 2])
def test_writer_bit_equal_on_small_batch_trees(batch, cuda_device):
    """K2 on a searched go9-shaped tree's materialize and expand sets at the
    eval game's B=1 and the lockstep evaluator's B=2, every lane writing
    and none."""
    engine, net, search, _ = _small_setup(9, 64, cuda_device)
    states = engine.init_batch(batch, device=cuda_device)
    _, tree = mcts.batched_search(selfplay.make_eval_fn(net), engine, states, 64,
                                  return_trees=True)
    t = tree.node_N.shape[1]
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    widx = torch.randint(0, t, (batch,), generator=gen, device=cuda_device).to(torch.int32)
    for arrays in (mcts.materialize_arrays(tree), [tree.child_P, tree.node_expanded]):
        rows = [torch.randint(-100, 100, (batch,) + a.shape[2:], generator=gen,
                              device=cuda_device).to(a.dtype) for a in arrays]
        for w in (widx, torch.full_like(widx, -1)):
            before = scatter_kernels.write_rows.launches
            check_writer(scatter_kernels.write_rows, arrays, rows, w)
            torch.cuda.synchronize()
            assert scatter_kernels.write_rows.launches == before + 1


def test_bfloat16_net_card_matches_cpu(cuda_device):
    """The go9-width bf16 net (BatchNorm float32) on the card against the
    same net on the CPU, both against the float32 net on the CPU: the
    card's bf16 error at most twice the CPU's (max abs, logits and value).
    cuDNN's bf16 convolutions round in another order than the CPU's;
    BatchNorm normalizes in float32 on both. Random weights through ten
    blocks give large logits, so the bf16 errors are whole units (on the
    H100: 4.6 on the card, 4.7 on the CPU) and the two bf16 nets stand as
    far apart (6.0): no absolute bound between them holds."""
    from alpha_zero_tpu_torch.models.resnet import to_inference_dtype

    cfg = config_lib.go9()
    master = build_network(cfg.env, cfg.network, device="cpu", seed=0, dtype="float32")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in master.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    obs = (torch.rand((64, 9, 9, 17), generator=gen) < 0.3).to(torch.int8)
    cpu = to_inference_dtype(copy.deepcopy(master), "bfloat16")
    card = to_inference_dtype(copy.deepcopy(master), "bfloat16").to(cuda_device)
    for name, value in card.state_dict().items():
        if "bn" in name and value.is_floating_point():
            assert value.dtype == torch.float32, name
    with torch.no_grad():
        ref, o_cpu = master(obs), cpu(obs)
        o_card = card(obs.to(cuda_device))
    o_card = [x.cpu() for x in o_card]

    def err(out, want):
        return [float((a - b).abs().max()) for a, b in zip(out, want)]

    card_err, cpu_err, apart = err(o_card, ref), err(o_cpu, ref), err(o_card, o_cpu)
    print(f"go9 bf16 net, max abs (logits, value): card vs f32 {card_err}, "
          f"CPU vs f32 {cpu_err}, card vs CPU {apart}; f32 logits max abs "
          f"{float(ref.pi_logits.abs().max()):.1f}")
    assert card_err[0] <= 2 * cpu_err[0] and card_err[1] <= 2 * cpu_err[1]


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


# ---------------------------------------------------------------------------
# The training path: Gomoku engine, learner, Trainer
# ---------------------------------------------------------------------------


def test_gomoku_engine_card_matches_cpu(cuda_device):
    """64 random 13x13 games, every field equal after every step."""
    engine = build_engine(config_lib.gomoku13().env)
    gen = torch.Generator().manual_seed(3)
    s_cpu = engine.init_batch(64, device="cpu")
    s_gpu = engine.init_batch(64, device=cuda_device)
    for i in range(170):
        weights = s_cpu.legal + s_cpu.done[:, None].float()  # any move once done
        moves = torch.multinomial(weights, 1, generator=gen)[:, 0].to(torch.int32)
        s_cpu = engine.step_batch(s_cpu, moves)
        s_gpu = engine.step_batch(s_gpu, moves.to(cuda_device))
        on_card = s_gpu.to_numpy()
        for key, val in s_cpu.to_numpy().items():
            assert (on_card[key] == val).all(), (i, key)
        if bool(s_cpu.done.all()):
            break
    assert bool(s_cpu.done.all()) and bool((s_cpu.winner != 0).any())


def test_writer_bit_equal_on_gomoku13_rows(cuda_device):
    """K2 on a searched 13x13 Gomoku tree's materialize set, whose dummy
    labels [1, 1] and group_libs [1] are int16: 2-byte rows."""
    cfg = config_lib.gomoku13()
    engine = build_engine(cfg.env)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8,
                                  num_fc_units=8, inference_dtype="float32")
    net = build_network(cfg.env, net_cfg, device=cuda_device, seed=0)
    trees, _ = select_bench.grown_trees(cfg, engine, net, 37, 16, 8, seed=2,
                                        device=cuda_device)
    tree = trees[1]
    arrays = mcts.materialize_arrays(tree)
    assert arrays[1].dtype == arrays[2].dtype == torch.int16
    assert arrays[1].shape[2:] == (1, 1) and arrays[2].shape[2:] == (1,)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    rows = [torch.randint(-100, 100, (37,) + a.shape[2:], generator=gen,
                          device=cuda_device).to(a.dtype) for a in arrays]
    widx = _ragged_widx(37, tree.node_N.shape[1], cuda_device)
    for w in (widx, torch.full_like(widx, -1)):
        check_writer(scatter_kernels.write_rows, arrays, rows, w)


def _two_go9_train_steps(device, dtype):
    """Two train steps of the go9-width net (10 x 128, weights of seed 0)
    at batch 64 on ``device`` with parameters in ``dtype``; returns the
    state and the losses [2, 2] (float64, on the CPU)."""
    from alpha_zero_tpu_torch.training import learner

    cfg = config_lib.go9()
    net_cfg = dataclasses.replace(cfg.network, inference_dtype="float32")
    net = build_network(cfg.env, net_cfg, device=device, seed=0, dtype="float32").to(dtype)
    state = learner.create_train_state(net, cfg.train)
    step = learner.make_train_step("float32")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for tid in (0, 3):
        obs = (torch.rand((64, 9, 9, 17), generator=gen) < 0.3).to(torch.int8)
        pi = torch.softmax(torch.randn((64, 82), generator=gen), -1).to(dtype)
        values = torch.randint(-1, 2, (64,), generator=gen).to(dtype)
        m = step(state, obs.to(device), pi.to(device), values.to(device), tid)
        losses.append(torch.stack([m.policy_loss, m.value_loss]).double().cpu())
    return state, torch.stack(losses)


def _distance(a, b):
    """(largest absolute difference of a weight or BN statistic, largest
    relative L2 difference of a momentum buffer) between two states."""
    sa, sb = a.net.state_dict(), b.net.state_dict()
    weights = max(float((sa[k].double().cpu() - sb[k].double().cpu()).abs().max())
                  for k in sa if sa[k].is_floating_point())
    momentum = max(
        float((a.optimizer.state[p]["momentum_buffer"].double().cpu()
               - b.optimizer.state[q]["momentum_buffer"].double().cpu()).norm()
              / b.optimizer.state[q]["momentum_buffer"].double().cpu().norm())
        for p, q in zip(a.net.parameters(), b.net.parameters()))
    return weights, momentum


def test_go9_train_step_card_matches_cpu(cuda_device):
    """Two float32 train steps of the go9-width net on the card (TF32 off)
    and on the CPU, against the same two steps in float64 on the CPU, from
    the same weights and batches. The step is ill-conditioned: Flax's
    train-mode variance E[x^2] - E[x]^2 cancels, so float32 rounding alone
    moves the weights after two steps by ~1e-4 and the momentum buffers by
    ~1e-2 in relative L2 norm, whichever float32 implementation runs them
    (the CPU's float32 steps: 8.4e-5 and 1.5e-2 from the float64 ones).
    So the card is held to the CPU's own float32 accuracy: its distance to
    the float64 steps at most three times the CPU's, and the losses within
    1e-4 of the CPU's. On the H100 the card measured 1.3 times the CPU's
    distance in the weights and 2.0 times in the momentum buffers: another
    summation order, in the worst-conditioned tensor."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card, card_losses = _two_go9_train_steps(cuda_device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    cpu, cpu_losses = _two_go9_train_steps("cpu", torch.float32)
    exact, _ = _two_go9_train_steps("cpu", torch.float64)
    card_err, cpu_err, apart = _distance(card, exact), _distance(cpu, exact), _distance(card, cpu)
    print(f"go9 train steps, (max |weight/BN diff|, max momentum rel L2): card vs float64 "
          f"{card_err}, CPU float32 vs float64 {cpu_err}, card vs CPU {apart}; losses "
          f"card - CPU {(card_losses - cpu_losses).abs().max().item():.3e}")
    assert float((card_losses - cpu_losses).abs().max()) < 1e-4
    assert card_err[0] <= 3 * cpu_err[0] and card_err[1] <= 3 * cpu_err[1]


def test_trainer_runs_on_the_card(cuda_device, tmp_path):
    """A micro run of the Trainer on the card: two generations, both
    checkpoints restorable bit-equal, the self-play net refreshed."""
    import copy

    from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
    from alpha_zero_tpu_torch.training import learner, pipeline

    cfg = config_lib.gomoku9()
    cfg = dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, board_size=5, num_stack=2, num_to_win=3),
        network=dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8,
                                    num_fc_units=8),
        search=dataclasses.replace(cfg.search, num_simulations=8, max_new_sims=4),
        train=dataclasses.replace(cfg.train, min_games=8, games_per_ckpt=8, batch_size=16,
                                  max_training_steps=4, ckpt_interval=2, log_interval=1),
        run=dataclasses.replace(cfg.run, ckpt_dir=str(tmp_path / "ckpt"),
                                logs_dir=str(tmp_path / "logs")),
        parallel=dataclasses.replace(cfg.parallel, selfplay_batch_size=8))
    snapshots = {}

    def on_checkpoint(trainer):
        snapshots[trainer.training_steps] = copy.deepcopy(trainer.train_state)
        master = trainer.train_state.net.state_dict()
        for name, value in trainer.play_net.state_dict().items():
            assert torch.equal(value, master[name].to(value.dtype)), name

    before = tree_kernels.select_leaf_batched.launches
    trainer = pipeline.train(cfg, device=cuda_device, on_checkpoint=on_checkpoint)
    assert tree_kernels.select_leaf_batched.launches > before
    assert trainer.replay.size == trainer.replay.num_samples_added > 0
    for step_count, snap in snapshots.items():
        fresh = learner.create_train_state(
            build_network(cfg.env, cfg.network, device=cuda_device, dtype="float32"),
            cfg.train)
        restored = ckpt_lib.restore_checkpoint(
            str(tmp_path / "ckpt" / f"training_steps_{step_count}"), fresh)
        for name, value in snap.net.state_dict().items():
            assert torch.equal(value, restored.net.state_dict()[name]), name
        assert restored.scheduler.state_dict() == snap.scheduler.state_dict()
