"""Parity: the port's batched Go engine against the JAX package's.

Random legal games (moves drawn with numpy from the shared legal mask), a
replayed in-repo SGF game, and the analysis of random boards go through both
engines; every GameState field must be equal after every step.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.go import GoEngine as JaxGoEngine
from alpha_zero_tpu.envs.types import jitted
from alpha_zero_tpu.search import mcts as jax_mcts
from alpha_zero_tpu.utils.coords import CoordsConvertor
from alpha_zero_tpu.utils.sgf import parse_sgf
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.types import GameState
from alpha_zero_tpu_torch.search import mcts

from torch_parity import assert_tree_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_both(jax_engine, engine, j_states, t_states, moves):
    j_states = jitted(jax_engine, "step_batch")(j_states, jnp.asarray(moves, jnp.int32))
    t_states = engine.step_batch(t_states, torch.from_numpy(moves.astype(np.int32)))
    assert_tree_equal(j_states, t_states)
    j_obs = jitted(jax_engine, "observation", batched=True)(j_states)
    np.testing.assert_array_equal(np.asarray(j_obs), engine.observation(t_states).numpy())
    return j_states, t_states


def _play_random_games(board_size, seed, max_steps=None, check=None):
    """Four games in one batch, to the end (double pass, max steps or a
    resignation), with captures and kos along the way; ``check(j_states,
    t_states)`` runs after every step."""
    n, batch = board_size, 4
    jax_engine = JaxGoEngine(board_size=n, num_stack=3, max_steps=max_steps)
    engine = GoEngine(board_size=n, num_stack=3, max_steps=max_steps)
    j_states = jax_engine.init_batch(batch)
    t_states = engine.init_batch(batch, device="cpu")
    assert_tree_equal(j_states, t_states)
    rng = np.random.RandomState(seed)
    for move_idx in range(jax_engine.max_steps + 1):
        legal = np.asarray(j_states.legal)
        moves = np.empty(batch, np.int64)
        for b in range(batch):
            cand = np.flatnonzero(legal[b])
            if len(cand) == 0:  # finished game: any move is a no-op
                cand = np.array([n * n])
            elif move_idx < n * n and len(cand) > 1:
                cand = cand[cand != n * n]  # few passes early: fights develop
            moves[b] = rng.choice(cand)
        if rng.rand() < 0.02:
            moves[rng.randint(batch)] = -1  # a resignation
        j_states, t_states = _step_both(jax_engine, engine, j_states, t_states, moves)
        if check is not None:
            check(j_states, t_states)
        if bool(np.asarray(j_states.done).all()):
            break
    assert bool(t_states.done.all())


@pytest.mark.parametrize("board_size,seed", [(5, 0), (5, 1), (9, 2)])
def test_random_games_match(board_size, seed):
    _play_random_games(board_size, seed)


def test_random_19x19_games_match():
    """19x19 (four games cut at 160 moves), where the search stores labels
    and liberty counts as int16: the node state of every step must match the
    JAX package's and give the engine's state back."""

    def check(j_states, t_states):
        ns = mcts._node_state_of(t_states)
        assert ns.labels.dtype == ns.group_libs.dtype == torch.int16
        assert_tree_equal(jax_mcts._node_state_of(j_states), ns)
        back = mcts._game_state_of(ns, t_states.legal.shape[-1])
        assert torch.equal(back.labels, t_states.labels)
        assert torch.equal(back.group_libs, t_states.group_libs)

    _play_random_games(19, 3, max_steps=160, check=check)


def test_sgf_game_replays_identically():
    """A 9x9 game from the repo's self-play records, to its scored end."""
    path = sorted(glob.glob(os.path.join(REPO, "logs/go/9x9/sgf/eval_*.sgf")))[0]
    with open(path) as f:
        game = parse_sgf(f.read())
    cc = CoordsConvertor(9)
    jax_engine = JaxGoEngine(board_size=9, num_stack=8, komi=game.komi or 7.5)
    engine = GoEngine(board_size=9, num_stack=8, komi=game.komi or 7.5)
    j_states = jax_engine.init_batch(1)
    t_states = engine.init_batch(1, device="cpu")
    for _, sgfc in game.moves:
        move = cc.to_flat(cc.from_sgf(sgfc))
        assert np.asarray(j_states.legal)[0, move] == 1.0
        j_states, t_states = _step_both(jax_engine, engine, j_states, t_states,
                                        np.array([move]))
    assert len(game.moves) > 50


@pytest.mark.parametrize("board_size", [5, 9, 19])
def test_analysis_and_scoring_of_random_boards(board_size):
    n, batch = board_size, 16
    rng = np.random.RandomState(board_size)
    boards = rng.choice([-1, 0, 1], size=(batch, n, n), p=[0.35, 0.3, 0.35]).astype(np.int8)
    jax_engine = JaxGoEngine(board_size=n, num_stack=2)
    engine = GoEngine(board_size=n, num_stack=2)
    j_states = jax_engine.init_batch(batch)
    j_states = j_states.replace(
        board=jnp.asarray(boards),
        to_play=jnp.asarray(rng.choice([-1, 1], size=batch).astype(np.int8)),
        ko=jnp.asarray(rng.randint(-1, n * n, size=batch).astype(np.int32)))
    t_states = GameState.from_numpy(j_states)
    j_out = jax.vmap(jax_engine.analyze)(j_states)
    t_out = engine.analyze(t_states)
    assert_tree_equal(j_out, t_out)
    j_black, j_white = jax.vmap(jax_engine.area_counts)(jnp.asarray(boards))
    t_black, t_white = engine.area_counts(torch.from_numpy(boards))
    np.testing.assert_array_equal(np.asarray(j_black), t_black.numpy())
    np.testing.assert_array_equal(np.asarray(j_white), t_white.numpy())
    np.testing.assert_array_equal(np.asarray(jax.vmap(jax_engine.score)(jnp.asarray(boards))),
                                  engine.score(torch.from_numpy(boards)).numpy())
