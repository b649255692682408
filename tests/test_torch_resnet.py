"""Parity: the port's ResNet loaded with ``params_from_flax`` against the
Flax net it was converted from."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.models.resnet import AlphaZeroNet as FlaxNet
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training import checkpoint as jax_ckpt
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.eval.dataset import build_eval_dataset
from alpha_zero_tpu_torch.models.resnet import (AlphaZeroNet, build_network,
                                                params_from_flax, to_inference_dtype)

from torch_parity import flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_net(variables, board_size, num_actions, blocks, filters, gomoku,
              dtype=torch.float32):
    net = AlphaZeroNet(num_actions=num_actions, board_size=board_size,
                       num_planes=5, num_res_blocks=blocks, num_filters=filters,
                       num_fc_units=filters, gomoku=gomoku)
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    return net.to(dtype).eval()


@pytest.mark.parametrize("board_size,gomoku,blocks,filters", [
    (9, False, 2, 16),   # Go stem, padding 1
    (7, True, 1, 8),     # Gomoku stem, padding 3
])
def test_float32_matches_flax(board_size, gomoku, blocks, filters):
    num_actions = board_size * board_size + (0 if gomoku else 1)
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 2, size=(6, board_size, board_size, 5)).astype(np.int8)
    flax_net = FlaxNet(num_actions=num_actions, num_res_blocks=blocks,
                       num_filters=filters, num_fc_units=filters, gomoku=gomoku)
    variables = flax_variables(flax_net, obs, seed=1)
    ref = flax_net.apply(variables, jnp.asarray(obs), train=False)
    net = _port_net(variables, board_size, num_actions, blocks, filters, gomoku)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(ref.pi_logits), out.pi_logits.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.value), out.value.numpy(),
                               rtol=0, atol=1e-5)


def test_bfloat16_port_tracks_float32_flax():
    """bf16 keeps 8 significant bits (relative rounding 2^-9 per operation):
    through a stem, two blocks and a head, logits of magnitude ~1 drift by a
    few 1e-3; 5e-2 bounds that drift with room, and is far below the spread
    of the logits themselves."""
    board_size, num_actions = 9, 82
    rng = np.random.RandomState(3)
    obs = rng.randint(0, 2, size=(6, board_size, board_size, 5)).astype(np.int8)
    flax_net = FlaxNet(num_actions=num_actions, num_res_blocks=2, num_filters=16,
                       num_fc_units=16)
    variables = flax_variables(flax_net, obs, seed=2)
    ref = flax_net.apply(variables, jnp.asarray(obs), train=False)
    net = _port_net(variables, board_size, num_actions, 2, 16, False, torch.bfloat16)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    assert out.pi_logits.dtype == torch.float32 and out.value.dtype == torch.float32
    ref_logits = np.asarray(ref.pi_logits)
    np.testing.assert_allclose(ref_logits, out.pi_logits.numpy(), rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.asarray(ref.value), out.value.numpy(), rtol=0, atol=5e-2)
    assert ref_logits.std() > 0.1


def test_build_network_go9_shapes():
    cfg = config_lib.go9()
    net = build_network(cfg.env, cfg.network, device="cpu", seed=0)
    assert next(net.parameters()).dtype == torch.bfloat16
    assert len(net.blocks) == 10 and net.stem_conv.out_channels == 128
    obs = torch.zeros((2, 9, 9, cfg.env.num_planes), dtype=torch.int8)
    with torch.no_grad():
        out = net(obs)
    assert out.pi_logits.shape == (2, 82) and out.value.shape == (2,)
    assert torch.isfinite(out.pi_logits).all() and torch.isfinite(out.value).all()


def test_bfloat16_nets_keep_batchnorm_in_float32():
    """Every bf16 net the port builds: convolutions and dense layers bf16,
    every BatchNorm tensor float32 and bit-equal to the float32 weights."""
    cfg = config_lib.go9()
    master = build_network(cfg.env, cfg.network, device="cpu", seed=0, dtype="float32")
    with torch.no_grad():
        for m in master.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)  # not representable in bf16
    net = to_inference_dtype(copy.deepcopy(master), "bfloat16")
    built = build_network(cfg.env, cfg.network, device="cpu", seed=0)
    master_sd = master.state_dict()
    for sd in (net.state_dict(), built.state_dict()):
        for name, value in sd.items():
            if "_bn" in name or ".bn" in name:
                if value.is_floating_point():
                    assert value.dtype == torch.float32, name
            elif value.is_floating_point():
                assert value.dtype == torch.bfloat16, name
    for name, value in net.state_dict().items():
        assert torch.equal(value, master_sd[name].to(value.dtype)), name
    assert not torch.equal(net.stem_bn.running_var,
                           master.stem_bn.running_var.bfloat16().float())


@pytest.fixture(scope="module")
def go9_ckpt_variables():
    """The Flax variables of ``logs/go/9x9/ckpt_20000``."""
    cfg = jax_config.go9()
    f32 = dataclasses.replace(cfg.network, inference_dtype="float32")
    tx, _ = jax_learner.make_optimizer(
        cfg.train.init_lr, cfg.train.lr_decay, cfg.train.lr_milestones,
        momentum=cfg.train.sgd_momentum, weight_decay=cfg.train.l2_regularization)
    template = jax_learner.create_train_state(
        jax_build_network(cfg.env, f32), jax.random.PRNGKey(0), (9, 9, 17), tx)
    state = jax_ckpt.restore_checkpoint(
        os.path.join(REPO, "logs", "go", "9x9", "ckpt_20000"), template)
    return {"params": state.params, "batch_stats": state.batch_stats}


def _gaps(logits, value, ref):
    """(value max abs, logits max abs, logits mean abs, argmax agreement)
    of one net's outputs against ``ref`` (Flax bf16)."""
    ref_logits, ref_value = np.asarray(ref.pi_logits), np.asarray(ref.value)
    d = np.abs(logits - ref_logits)
    return (float(np.abs(value - ref_value).max()), float(d.max()), float(d.mean()),
            float((logits.argmax(-1) == ref_logits.argmax(-1)).mean()))


def test_bfloat16_go9_checkpoint_tracks_flax_bfloat16(go9_ckpt_variables):
    """The port's bf16 net against Flax's bf16 net (the JAX package's
    inference) at go9 width on the trained ``ckpt_20000``, over 256
    positions of the in-repo go9 games (``logs/go/9x9_matched/sgf``). The
    bound is Flax's own float32 net's distance from Flax bf16, measured
    here: the port's bf16 net must be no further from Flax bf16 in value
    and logits (max abs), in mean logit error, and in argmax agreement.
    With BatchNorm rounded to bf16 (the whole net cast) the port broke
    all four bounds: value 0.078 against 0.054, logits 0.125 against
    0.106."""
    variables = go9_ckpt_variables
    ds = build_eval_dataset(os.path.join(REPO, "logs", "go", "9x9_matched", "sgf"),
                            9, 8, device="cpu")
    obs = ds.states[np.linspace(0, len(ds) - 1, 256).round().astype(int)]
    cfg = jax_config.go9()
    ref = jax_build_network(cfg.env, cfg.network).apply(
        variables, jnp.asarray(obs), train=False)
    f32 = jax_build_network(
        cfg.env, dataclasses.replace(cfg.network, inference_dtype="float32")).apply(
        variables, jnp.asarray(obs), train=False)
    bound = _gaps(np.asarray(f32.pi_logits), np.asarray(f32.value), ref)

    port_cfg = config_lib.go9()
    net = build_network(port_cfg.env, port_cfg.network, device="cpu", dtype="float32")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    net = to_inference_dtype(net, port_cfg.network.inference_dtype)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    got = _gaps(out.pi_logits.numpy(), out.value.numpy(), ref)
    print(f"against Flax bf16 (value max, logits max, logits mean, argmax): "
          f"port bf16 {got}, Flax f32 {bound}")
    assert np.asarray(ref.value).std() > 0.1
    assert got[0] <= bound[0] and got[1] <= bound[1] and got[2] <= bound[2]
    assert got[3] >= bound[3]
