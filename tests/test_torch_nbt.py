"""KataGo's nested-bottleneck net (``models/nbt.py``) on the CPU, held to its
plain float32 formulation, the benchmark's ``azbench/reference/nets/nbt.py``
(which imports nothing of the port): the outputs, the state-dict names, bf16 inference, a train step, a checkpoint, self-play,
the model axis refused, the net's spans and counters; and the ResNet path
as it was before the second net came.

The small net: 4 blocks on a 32 trunk, 16 mid channels, 8 pooled channels,
heads of 8 / 8 / 16 channels and 16 value units, pooling in block 2, on
5x5 and 9x9 Go. Its norms' running statistics are set from a batch of
boards (``_calibrate``), so that the logits spread as a trained net's do
and the values do not sit at +-1.
"""

import contextlib
import copy
import dataclasses
import hashlib

import pytest
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models import nbt
from alpha_zero_tpu_torch.models.resnet import (AlphaZeroNet, build_network, count_params,
                                                to_inference_dtype)
from alpha_zero_tpu_torch.parallel.mesh import Mesh
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner, selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils import trace
from azbench.reference.nets import nbt as nbt_ref

SMALL = dict(architecture="nbt", num_res_blocks=4, num_filters=32, nbt_mid_channels=16,
             nbt_gpool_channels=8, nbt_gpool_blocks="2", nbt_policy_channels=8,
             nbt_policy_gpool_channels=8, nbt_value_channels=16, num_fc_units=16)
POOLING_BLOCKS = 1


def _configs(board_size: int = 5, dtype: str = "float32"):
    cfg = config_lib.go19_b18c384nbt()
    env = dataclasses.replace(cfg.env, board_size=board_size, max_steps=2 * board_size ** 2)
    return env, dataclasses.replace(cfg.network, inference_dtype=dtype, **SMALL)


def _ref_cfg(env, net_cfg) -> dict:
    """The reference's ``cfg``: the env and network fields merged."""
    return {**dataclasses.asdict(env), **dataclasses.asdict(net_cfg)}


def _boards(env, rows: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    n = env.board_size
    density = torch.rand((rows, 1, 1, 1), generator=gen) * 0.6
    return (torch.rand((rows, n, n, env.num_planes), generator=gen) < density).to(torch.int8)


def _calibrate(net, obs) -> None:
    """Every norm's running statistics set to its input's batch moments in
    ``obs``: one train-mode pass with momentum 1."""
    norms = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    net.train()
    with torch.no_grad():
        net(obs)
    for m in norms:
        m.momentum = 0.1
    net.eval()


def _small_net(board_size: int = 5, seed: int = 3):
    env, net_cfg = _configs(board_size)
    net = build_network(env, net_cfg, device="cpu", seed=seed)
    _calibrate(net, _boards(env, 64, seed + 100))
    return env, net_cfg, net


@pytest.mark.parametrize("board_size", [5, 9])
def test_float32_matches_the_reference(board_size):
    """The port's float32 net against the reference's equations on the same
    weights. They compute the same sums in other orders (eval-mode
    ``F.batch_norm`` against the written-out normalisation, the convolution
    routine's own blocking): float32 rounds each at ~6e-8 of the value, and
    through ~40 layers that stays near 1e-6 of the largest logit; 1e-5 of it
    bounds that with room and is far below the logits' spread."""
    env, net_cfg, net = _small_net(board_size)
    w = {k: v.float() for k, v in net.state_dict().items()}
    obs = _boards(env, 16, 7)
    with torch.no_grad():
        out = net(obs)
        logits, value = nbt_ref.forward(w, _ref_cfg(env, net_cfg), obs)
    assert out.pi_logits.shape == (16, board_size ** 2 + 1) and out.value.shape == (16,)
    scale = float(logits.abs().max())
    torch.testing.assert_close(out.pi_logits, logits, rtol=0.0, atol=1e-5 * scale)
    torch.testing.assert_close(out.value, value, rtol=0.0, atol=1e-5)
    assert float(logits.std(dim=1).mean()) > 0.1 and float(value.abs().max()) < 0.99


def test_state_dict_names_are_the_references():
    """The port's state dict holds the reference's tensors under the same
    names and shapes, plus each norm's ``num_batches_tracked``; the
    reference's draw loads strictly and reads back unchanged."""
    env, net_cfg, net = _small_net()
    rcfg = _ref_cfg(env, net_cfg)
    drawn = nbt_ref.make_weights(rcfg, 5, "cpu")
    counters = {f"{prefix}.num_batches_tracked" for prefix, _ in nbt_ref.layout(rcfg)[1]}
    assert set(net.state_dict()) == set(drawn) | counters
    net.load_state_dict({**drawn, **{k: torch.tensor(0) for k in counters}}, strict=True)
    assert all(torch.equal(net.state_dict()[k], v) for k, v in drawn.items())
    del drawn["blocks.1.inner.0.gfc.bias"]
    with pytest.raises(RuntimeError, match="gfc.bias"):
        net.load_state_dict(drawn, strict=True)


def test_bfloat16_tracks_float32():
    """bf16 keeps 8 significant bits (2^-9 relative rounding an operation);
    through ~40 layers the logits here drift by 3.5-4% of their largest
    magnitude and the value by ~0.01. 10% of it, and 0.05 on the value,
    bound that with room while a net with a layer left out moves by far
    more."""
    env, net_cfg, net = _small_net(9)
    half = to_inference_dtype(build_network(env, net_cfg, device="cpu", dtype="float32"),
                              "bfloat16")
    half.load_state_dict(net.state_dict())
    assert half.stem_conv.weight.dtype == torch.bfloat16
    assert half.blocks[1].inner[0].gbn.running_var.dtype == torch.float32
    obs = _boards(env, 16, 8)
    with torch.no_grad():
        out, ref = half(obs), net(obs)
    assert out.pi_logits.dtype == torch.float32 and out.value.dtype == torch.float32
    scale = float(ref.pi_logits.abs().max())
    torch.testing.assert_close(out.pi_logits, ref.pi_logits, rtol=0.0, atol=0.1 * scale)
    torch.testing.assert_close(out.value, ref.value, rtol=0.0, atol=0.05)


def _batch(env, seed):
    gen = torch.Generator().manual_seed(seed)
    pi = torch.rand((8, env.num_actions), generator=gen)
    pi = pi / pi.sum(dim=1, keepdim=True)
    v = torch.where(torch.rand(8, generator=gen) < 0.5, -1.0, 1.0)
    return _boards(env, 8, seed), pi, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_train_step_moves_every_parameter(dtype):
    env, net_cfg = _configs(5)
    train = config_lib.go19_b18c384nbt().train
    net = build_network(env, net_cfg, device="cpu", seed=4, dtype="float32")
    state = learner.create_train_state(net, train)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    metrics = learner.make_train_step(dtype)(state, *_batch(env, 1), transform_id=3)
    assert torch.isfinite(metrics.policy_loss) and torch.isfinite(metrics.value_loss)
    after = net.state_dict()
    for name, _ in net.named_parameters():
        assert not torch.equal(before[name], after[name]), name
    for name in before:
        if name.endswith(("running_mean", "running_var")):
            assert not torch.equal(before[name], after[name]), name
    assert state.training_steps == 1


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    env, net_cfg = _configs(5)
    train = config_lib.go19_b18c384nbt().train
    step = learner.make_train_step("float32")
    state = learner.create_train_state(
        build_network(env, net_cfg, device="cpu", seed=4, dtype="float32"), train)
    for i in range(2):
        step(state, *_batch(env, i), transform_id=i)
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, state.training_steps)
    fresh = learner.create_train_state(
        build_network(env, net_cfg, device="cpu", seed=9, dtype="float32"), train)
    restored = ckpt_lib.restore_checkpoint(path, fresh)
    assert ckpt_lib.states_equal(state, restored)
    m1 = step(state, *_batch(env, 5), transform_id=2)
    m2 = step(restored, *_batch(env, 5), transform_id=2)
    assert torch.equal(m1.policy_loss, m2.policy_loss) and torch.equal(m1.value_loss, m2.value_loss)
    assert ckpt_lib.states_equal(state, restored)


def test_model_axis_is_refused():
    env, net_cfg = _configs(5)
    with pytest.raises(ValueError, match="no model axis"):
        build_network(env, net_cfg, device="cpu", mesh=Mesh(dp=1, mdl=2))
    assert build_network(env, net_cfg, device="cpu", mesh=Mesh(dp=2, mdl=1)).sharded_names() == set()


@pytest.mark.parametrize("field, value, match", [
    ("architecture", "transformer", "'resnet' or 'nbt'"),
    ("nbt_gpool_blocks", "2,5", r"\[5\] are not among blocks 1..4"),
    ("gomoku", True, "plays Go"),
])
def test_bad_configs_are_refused(field, value, match):
    env, net_cfg = _configs(5)
    with pytest.raises(ValueError, match=match):
        build_network(env, dataclasses.replace(net_cfg, **{field: value}), device="cpu")


def test_selfplay_plays_through_the_step():
    """Three moves of 6 games through ``training/selfplay.py``: every move
    legal, the search's policy a distribution."""
    env, net_cfg, net = _small_net(5)
    cfg = config_lib.go19_b18c384nbt()
    search = dataclasses.replace(cfg.search, num_simulations=12, max_new_sims=8,
                                 warm_up_steps=2)
    engine = build_engine(env)
    step = selfplay.make_selfplay_step(engine, net, search, cfg.resign, device="cpu")
    gen = torch.Generator().manual_seed(2)
    sp = selfplay.init_selfplay_state(engine, 6, gen, -1.0, 0.0, reuse_num_simulations=12,
                                      device="cpu")
    for _ in range(3):
        legal = sp.games.legal.clone()
        sp, out = step(sp, gen, -1.0)
        assert bool((legal.gather(1, out.move.long()[:, None]) > 0.5).all())
        torch.testing.assert_close(out.search_pi.sum(-1), torch.ones(6))
    assert sp.trees is not None  # reuse on: the trees go on to the next move


def test_spans_and_counters_nest_under_net():
    env, net_cfg, net = _small_net(5)
    eval_fn = selfplay.make_eval_fn(net)
    obs = [_boards(env, rows, 3) for rows in (5, 7)]
    trace.enable()
    try:
        for o in obs:
            eval_fn(o)
    finally:
        record = trace.disable()
    names = [s.name for s in record.spans]
    assert names.count("net") == 2 and names.count("net.trunk") == 2
    assert names.count("net.heads") == 2 and names.count("net.gpool") == 2 * (POOLING_BLOCKS + 2)
    for s in record.spans:
        if s.name in ("net.trunk", "net.heads"):
            assert record.spans[s.parent].name == "net"
        elif s.name == "net.gpool":
            assert record.spans[s.parent].name in ("net.trunk", "net.heads")
            assert record.spans[record.spans[s.parent].parent].name == "net"
    totals = {}
    for c in record.counts:
        totals[c.name] = totals.get(c.name, 0) + c.n
    # Every norm of the net runs once a call, here on the CPU as plain ops.
    norms = sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    assert totals == {"net.positions": 12, "net.gpool_sites": 2 * (POOLING_BLOCKS + 2),
                      "net.plain_norms": 2 * norms}

    with torch.no_grad():
        net(obs[0])  # tracing off: nothing recorded
    assert trace.disable().spans == []


def test_the_preset_is_b18c384nbt():
    cfg = config_lib.get_config("go19_b18c384nbt")
    jumbo = config_lib.go19_jumbo()
    assert (cfg.env, cfg.search, cfg.resign, cfg.train, cfg.parallel) == (
        jumbo.env, jumbo.search, jumbo.resign, jumbo.train, jumbo.parallel)
    net = build_network(cfg.env, cfg.network, device="cpu", dtype="float32")
    assert isinstance(net, nbt.NestedBottleneckNet) and len(net.blocks) == 18
    assert net.stem_conv.weight.shape == (384, 17, 5, 5)
    pooling = [i for i, b in enumerate(net.blocks)
               if isinstance(b.inner[0], nbt.PoolingInnerBlock)]
    assert pooling == [2, 5, 8, 11, 14]
    assert net.blocks[2].inner[0].gconv.weight.shape == (64, 192, 3, 3)
    drawn = nbt_ref.make_weights(_ref_cfg(cfg.env, cfg.network), 0, "cpu")
    assert set(drawn) == {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    params = dict(net.named_parameters())
    assert count_params(net) == sum(v.numel() for k, v in drawn.items() if k in params)
    assert count_params(net) == 26_450_242
    assert next(build_network(cfg.env, cfg.network, device="cpu").parameters()).dtype == (
        torch.bfloat16)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# The sha256 of the state dict (names and bytes, in order) and of the
# outputs of a 2 x 16 ResNet built by ``build_network(seed=5)`` on six
# seeded boards, taken before ``build_network`` built a second net, with
# one intra-op thread (float32 sums on the CPU are split by thread count).
RESNET_DIGESTS = {
    ("go9", "float32"): ("1ef38501fe467d62ba018f4c3be4b262e503229d7a616b323961ad0e4570e080",
                         "2639f524b58f114425d3db54007ab3ee323f5c9af255ba2b4610af245a9403fd"),
    ("go9", "bfloat16"): ("b9b4934f740fd30e89b70d8417d3da51c68b9036b3a6369264a3c950a0048f85",
                          "7844b358c12dc35e0c47bdc3ed7135da8dfffd427846e9c5edcb8eaf479f4d48"),
    ("gomoku13", "float32"): ("b16373d394648818f79be0e8dbb9c5d36a7cfe4090c9265f7e8adfda2cfdc8f3",
                              "09482776cb91efd16abd3b89a04b02975095165a626f514a354f76ecd9f30fdd"),
    ("gomoku13", "bfloat16"): ("2e4164c28a894786e4a8bfec58a9f5dd12e8326c84975ba3cc882f715965b74d",
                               "d4f1afcfa275d0636d5053a8804910eb205084ff19710772ffbb6cb718e76335"),
}


@pytest.mark.parametrize("name, dtype", sorted(RESNET_DIGESTS))
def test_the_resnet_is_the_parents_bit_for_bit(name, dtype):
    cfg = config_lib.get_config(name)
    assert cfg.network.architecture == "resnet"
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                  num_fc_units=16, inference_dtype=dtype)
    n = cfg.env.board_size
    obs = torch.randint(0, 2, (6, n, n, cfg.env.num_planes),
                        generator=torch.Generator().manual_seed(11)).to(torch.int8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net = build_network(cfg.env, net_cfg, device="cpu", seed=5)
        with torch.no_grad():
            out = net(obs)
    finally:
        torch.set_num_threads(threads)
    assert type(net) is AlphaZeroNet and len(net.state_dict()) == 48
    assert (_digest(net.state_dict().items()),
            _digest([("pi", out.pi_logits), ("v", out.value)])) == RESNET_DIGESTS[name, dtype]


def test_each_block_hands_on_the_next_norms_activation():
    """The blocks map a norm's activation to their residual branch, and
    ``residual_stack`` adds each branch and applies the norm after it (the
    next block's ``bn_in``, the next inner block's ``bn1``, the block's
    ``bn_out``, the trunk's ``trunk_bn``) in one pass: the trunk computes
    what the plain chain of blocks computes, norm by norm, in eval and in
    train mode (the running statistics moved alike)."""
    env, net_cfg, net = _small_net(5)
    obs = _boards(env, 6, 8)

    def chain(net, x):
        from torch.nn import functional as F

        def act(bn, t):
            return F.relu(bn(t))

        y = net.stem_conv(x.permute(0, 3, 1, 2).to(net.stem_conv.weight.dtype))
        for block in net.blocks:
            t = block.conv_in(act(block.bn_in, y))
            for inner in block.inner:
                a = act(inner.bn1, t)
                h = inner.conv1(a)
                if isinstance(inner, nbt.PoolingInnerBlock):
                    g = act(inner.gbn, inner.gconv(a))
                    h = h + inner.gfc(nbt.gpool(g, inner.scale))[:, :, None, None]
                t = t + inner.conv2(act(inner.bn2, h))
            y = y + block.conv_out(act(block.bn_out, t))
        return act(net.trunk_bn, y)

    def trunk(net, x):
        with trace_counts() as counts:
            y = net.stem_conv(x.permute(0, 3, 1, 2).to(net.stem_conv.weight.dtype))
            norms = [b.bn_in for b in net.blocks] + [net.trunk_bn]
            a = nbt.residual_stack(y, net.blocks, norms)
        return a, counts

    with torch.no_grad():
        a, counts = trunk(net, obs)
        assert torch.equal(a, chain(net, obs))
    norms = sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    # Every norm but the heads' three.
    assert counts == {"net.plain_norms": norms - 3, "net.gpool_sites": POOLING_BLOCKS}
    twin = copy.deepcopy(net).train()
    net.train()
    assert torch.equal(trunk(net, obs)[0], chain(twin, obs))
    for m, t in zip(net.modules(), twin.modules()):
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.running_mean, t.running_mean)
            assert torch.equal(m.running_var, t.running_var)


@contextlib.contextmanager
def trace_counts():
    """The counters' totals recorded inside the block."""
    totals = {}
    trace.enable()
    try:
        yield totals
    finally:
        for c in trace.disable().counts:
            totals[c.name] = totals.get(c.name, 0) + c.n

