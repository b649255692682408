"""Parity: the port's ResNet loaded with ``params_from_flax`` against the
Flax net it was converted from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.models.resnet import AlphaZeroNet as FlaxNet
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import (AlphaZeroNet, build_network,
                                                params_from_flax)


def _flax_variables(net, obs, seed):
    """Initialized variables with randomized BN scale/bias/statistics, so
    every BN term of the conversion shows in the output."""
    variables = net.init(jax.random.PRNGKey(seed), jnp.asarray(obs), train=False)
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        return x

    return {k: jax.tree_util.tree_map_with_path(perturb, variables[k])
            for k in ("params", "batch_stats")}


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
    variables = _flax_variables(flax_net, obs, seed=1)
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
    variables = _flax_variables(flax_net, obs, seed=2)
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
