"""Parity of the slice as a whole: three self-play moves of the port against
the JAX package's ``make_selfplay_step``.

5x5 Go, a float32 2-block x 16-filter net (the port loads the Flax weights
with ``params_from_flax``), 16 simulations with subtree reuse and
``max_new_sims=8``, four games, and an active resign threshold so that the
resign branch, the auto-reset and the fresh trees after a finished game all
run. The port is fed the JAX package's random draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training import selfplay as jax_selfplay
from alpha_zero_tpu.training.pipeline import build_engine as jax_build_engine
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine

from torch_parity import assert_tree_equal

BATCH, SIMS, MOVES = 4, 16, 3
THRESHOLD = 0.9  # above almost every root Q: enabled games resign at move 2
TOL = {"search_pi": 1e-5, "root_q": 1e-5, "best_child_q": 1e-5}


def _configs(lib):
    cfg = lib.go9()
    env = dataclasses.replace(cfg.env, board_size=5)
    net = dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                              num_fc_units=16, inference_dtype="float32")
    search = dataclasses.replace(cfg.search, num_simulations=SIMS, max_new_sims=8,
                                 reuse_subtree=True)
    resign = dataclasses.replace(cfg.resign, init_resign_threshold=THRESHOLD,
                                 check_resign_after_steps=1, disable_resign_ratio=0.5)
    return env, net, search, resign


def _jax_draws(key, num_actions):
    """The three draws JAX's selfplay step makes from ``key``."""
    rng_search, rng_move, rng_resign = jax.random.split(key, 3)
    alpha = jnp.full((num_actions,), 0.03, jnp.float32)
    dirichlet = jax.vmap(lambda k: jax.random.dirichlet(k, alpha))(
        jax.random.split(rng_search, BATCH))
    gumbel = jax.random.gumbel(rng_move, (BATCH, num_actions), jnp.float32)
    resign_u = jax.random.uniform(rng_resign, (BATCH,))
    return selfplay.SelfplayNoise(
        *(torch.from_numpy(np.array(x)) for x in (dirichlet, gumbel, resign_u)))


def test_three_moves_match_jax():
    env, net_cfg, search, resign = _configs(jax_config)
    jax_engine = jax_build_engine(env)
    flax_net = jax_build_network(env, net_cfg)
    obs0 = jnp.zeros((1, 5, 5, env.num_planes), jnp.int8)
    variables = flax_net.init(jax.random.PRNGKey(0), obs0, train=False)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jax_step = jax_selfplay.make_selfplay_step(jax_engine, flax_net, search, resign)
    init_key = jax.random.PRNGKey(1)
    jax_sp = jax_selfplay.init_selfplay_state(
        jax_engine, BATCH, init_key, resign_threshold=THRESHOLD,
        disable_resign_ratio=resign.disable_resign_ratio, reuse_num_simulations=SIMS)

    env_t, net_cfg_t, search_t, resign_t = _configs(config_lib)
    engine = build_engine(env_t)
    net = build_network(env_t, net_cfg_t, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    step = selfplay.make_selfplay_step(engine, net, search_t, resign_t, device="cpu")
    sp = selfplay.init_selfplay_state(
        engine, BATCH, None, THRESHOLD, resign_t.disable_resign_ratio,
        reuse_num_simulations=SIMS,
        resign_u=torch.from_numpy(np.array(jax.random.uniform(init_key, (BATCH,)))),
        device="cpu")
    assert_tree_equal(jax_sp.resign_disabled, sp.resign_disabled)

    resigned = 0
    for i in range(MOVES):
        key = jax.random.PRNGKey(100 + i)
        jax_sp, ref = jax_step(variables, jax_sp, key, jnp.float32(THRESHOLD))
        sp, out = step(sp, None, THRESHOLD, noise=_jax_draws(key, engine.num_actions))
        assert_tree_equal(ref._asdict(), out._asdict(), TOL)
        resigned += int(out.resigned.sum())
    assert_tree_equal(jax_sp.games, sp.games)
    assert_tree_equal(jax_sp.trees, sp.trees, {"node_W": 1e-5, "node_P": 1e-6,
                                               "child_P": 1e-6})
    assert 0 < resigned < BATCH  # the resign branch ran, and not everywhere


def test_accumulator_finishes_resigned_games():
    env, net_cfg, search, resign = _configs(config_lib)
    engine = build_engine(env)
    net = build_network(env, net_cfg, device="cpu", seed=1)
    step = selfplay.make_selfplay_step(engine, net, search, resign, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sp = selfplay.init_selfplay_state(engine, BATCH, gen, THRESHOLD, 0.0,
                                      reuse_num_simulations=SIMS, device="cpu")
    acc = selfplay.EpisodeAccumulator(BATCH, num_planes=env.num_planes)
    finished = []
    for _ in range(MOVES):
        sp, out = step(sp, gen, THRESHOLD)
        finished += acc.add_step(out)
    assert len(finished) == BATCH  # every game resigned at move 2
    for game in finished:
        assert game.states.shape == (MOVES, 5, 5, env.num_planes)
        assert game.stats["game_result"].endswith("+R")
        assert np.allclose(game.pi_probs.sum(-1), 1.0, atol=1e-5)
    assert not bool(sp.games.done.any())
