"""Parity of the port's CPU oracle search (``search/reference.py``) with the
JAX package's, and of the port's batched search with the port's oracle.

- Oracle against oracle: 5x5 Go and 5x5 Gomoku (three in a row) from
  positions a few random moves in (a numpy seed), one deterministic
  evaluation function of the observation fed to both: the root child
  counts equal, the root Q within 1e-6.
- The port's ``batched_search`` against the port's oracle, as
  ``tests/test_oracle_search.py`` holds the JAX package's: a fixed prior and
  a value that counts material (exact in float32), the same child counts,
  the root Q within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.go import GoEngine as JaxGoEngine
from alpha_zero_tpu.envs.gomoku import GomokuEngine as JaxGomokuEngine
from alpha_zero_tpu.envs.types import jitted
from alpha_zero_tpu.search.reference import oracle_search as jax_oracle_search
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.gomoku import GomokuEngine
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.search.reference import oracle_search

from torch_parity import one_torch_thread  # noqa: F401

ENGINES = {
    "go5": (lambda: JaxGoEngine(board_size=5, num_stack=2),
            lambda: GoEngine(board_size=5, num_stack=2)),
    "gomoku5": (lambda: JaxGomokuEngine(board_size=5, num_stack=2, num_to_win=3),
                lambda: GomokuEngine(board_size=5, num_stack=2, num_to_win=3)),
}


def _positions(name, moves, seed):
    """The same position in both packages: ``moves`` random board moves
    (no pass) from a numpy seed, played from the empty board."""
    make_jax, make_port = ENGINES[name]
    j_engine, engine = make_jax(), make_port()
    step = jitted(j_engine, "step")
    j_state, state = j_engine.init(), engine.init(device="cpu")
    rng = np.random.RandomState(seed)
    n2 = engine.board_size ** 2
    for _ in range(moves):
        legal = np.flatnonzero(np.asarray(j_state.legal)[:n2])
        move = int(rng.choice(legal))
        j_state, state = step(j_state, jnp.int32(move)), engine.step(state, move)
    np.testing.assert_array_equal(np.asarray(j_state.board), state.board[0].numpy())
    return (j_engine, j_state), (engine, state)


def _obs_eval(num_actions, obs_size, seed):
    """A deterministic evaluation of one observation (int8 [N, N, C]): a
    softmax of a fixed random linear map, and the tanh of another."""
    rng = np.random.RandomState(seed)
    w_pi = rng.randn(obs_size, num_actions) * 0.3
    w_v = rng.randn(obs_size) * 0.1

    def eval_func(obs):
        x = np.asarray(obs, np.float64).reshape(-1)
        logits = x @ w_pi
        p = np.exp(logits - logits.max())
        return (p / p.sum()).astype(np.float32), float(np.tanh(x @ w_v))

    return eval_func


@pytest.mark.parametrize("name,moves,sims,seed", [
    ("go5", 0, 60, 0), ("go5", 6, 60, 1), ("go5", 12, 40, 2),
    ("gomoku5", 2, 60, 3), ("gomoku5", 5, 40, 4),
])
def test_oracle_like_jax(name, moves, sims, seed):
    (j_engine, j_state), (engine, state) = _positions(name, moves, seed)
    obs_size = engine.observation(state)[0].numel()
    eval_func = _obs_eval(engine.num_actions, obs_size, seed)
    ref_n, ref_q = jax_oracle_search(j_engine, j_state, eval_func, sims)
    out_n, out_q = oracle_search(engine, state, eval_func, sims)
    np.testing.assert_array_equal(ref_n, out_n)
    assert out_n.sum() == sims - 1
    assert abs(ref_q - out_q) <= 1e-6


@pytest.mark.parametrize("name,moves,sims,seed", [
    ("gomoku5", 3, 40, 5), ("go5", 4, 48, 6), ("go5", 10, 32, 7),
])
def test_batched_search_like_oracle(name, moves, sims, seed):
    _, (engine, state) = _positions(name, moves, seed)
    prior = np.random.RandomState(seed).dirichlet(np.ones(engine.num_actions))
    prior = prior.astype(np.float32)

    def material(own, opp):
        return float((int(own.sum()) - int(opp.sum())) * 0.05)

    def eval_func(obs):
        obs = obs.astype(np.int32)
        return prior.copy(), material(obs[..., 0], obs[..., 1])

    def eval_fn(obs):
        b = obs.shape[0]
        own = obs[..., 0].to(torch.int32).sum((1, 2))
        opp = obs[..., 1].to(torch.int32).sum((1, 2))
        return (torch.from_numpy(prior).expand(b, -1),
                (own - opp).float() * 0.05)

    oracle_n, oracle_q = oracle_search(engine, state, eval_func, sims)
    result = mcts.batched_search(eval_fn, engine, state, num_simulations=sims)
    np.testing.assert_array_equal(result.child_N[0].numpy(), oracle_n)
    assert abs(float(result.root_Q[0]) - oracle_q) < 1e-5
