"""Parity: the port's batched Gomoku engine against the JAX package's.

Random games on 5x5 (three in a row wins), 9x9 and 13x13 boards go through
both engines from moves drawn with numpy over the shared legal mask; every
GameState field and the observation must be equal after every step. The
cases of ``tests/test_gomoku_engine.py`` (four directions and both colors,
six in a row, a draw, the no-op after a finished game) run on both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.gomoku import GomokuEngine as JaxGomokuEngine
from alpha_zero_tpu.envs.types import BLACK, WHITE, jitted
from alpha_zero_tpu.search import mcts as jax_mcts
from alpha_zero_tpu_torch.envs.gomoku import GomokuEngine
from alpha_zero_tpu_torch.envs.types import GameState
from alpha_zero_tpu_torch.search import mcts

from torch_parity import assert_tree_equal


def _engines(n, k=5, num_stack=3, max_steps=None):
    return (JaxGomokuEngine(board_size=n, num_stack=num_stack, num_to_win=k,
                            max_steps=max_steps),
            GomokuEngine(board_size=n, num_stack=num_stack, num_to_win=k,
                         max_steps=max_steps))


def _step_both(jax_engine, engine, j_states, t_states, moves):
    j_states = jitted(jax_engine, "step_batch")(j_states, jnp.asarray(moves, jnp.int32))
    t_states = engine.step_batch(t_states, torch.from_numpy(moves.astype(np.int32)))
    assert_tree_equal(j_states, t_states)
    j_obs = jitted(jax_engine, "observation", batched=True)(j_states)
    np.testing.assert_array_equal(np.asarray(j_obs), engine.observation(t_states).numpy())
    return j_states, t_states


@pytest.mark.parametrize("board_size,k,seed", [(5, 3, 0), (5, 3, 1), (9, 5, 2), (13, 5, 3)])
def test_random_games_match(board_size, k, seed):
    """Eight games in one batch, played to their end (a win or a full
    board); a finished game keeps receiving moves, which are no-ops."""
    n, batch = board_size, 8
    jax_engine, engine = _engines(n, k)
    j_states = jax_engine.init_batch(batch)
    t_states = engine.init_batch(batch, device="cpu")
    assert_tree_equal(j_states, t_states)
    rng = np.random.RandomState(seed)
    for _ in range(n * n + 1):
        legal = np.asarray(j_states.legal)
        moves = np.array([rng.choice(np.flatnonzero(row)) if row.any()
                          else rng.randint(n * n) for row in legal])
        j_states, t_states = _step_both(jax_engine, engine, j_states, t_states, moves)
        if bool(np.asarray(j_states.done).all()):
            break
    assert bool(t_states.done.all())
    assert (t_states.winner != 0).any()


def test_13x13_node_state_is_int16():
    """At 13x13 (N*N = 169 > 127) the search stores the dummy labels
    [1, 1] and group_libs [1] as int16 — 2-byte rows in the tree-row
    writer's materialize set — and gets the engine state back."""
    jax_engine, engine = _engines(13)
    rng = np.random.RandomState(4)
    j_states, t_states = jax_engine.init_batch(4), engine.init_batch(4, device="cpu")
    for _ in range(6):
        moves = np.array([rng.choice(np.flatnonzero(r)) for r in np.asarray(j_states.legal)])
        j_states, t_states = _step_both(jax_engine, engine, j_states, t_states, moves)
    ns = mcts._node_state_of(t_states)
    assert ns.labels.dtype == ns.group_libs.dtype == torch.int16
    assert ns.labels.shape == (4, 1, 1) and ns.group_libs.shape == (4, 1)
    assert_tree_equal(jax_mcts._node_state_of(j_states), ns)
    back = mcts._game_state_of(ns, engine.num_actions)
    assert torch.equal(back.labels, t_states.labels)
    assert torch.equal(back.group_libs, t_states.group_libs)


def _flat(n, r, c):
    return r * n + c


def _play(moves, n=9, k=5):
    """One game through both engines (batch of 1); returns the port's."""
    jax_engine, engine = _engines(n, k, num_stack=8)
    j_states = jax_engine.init_batch(1)
    t_states = engine.init_batch(1, device="cpu")
    for m in moves:
        j_states, t_states = _step_both(jax_engine, engine, j_states, t_states,
                                        np.array([m]))
    return engine, t_states


@pytest.mark.parametrize("direction", ["horizontal", "vertical", "diag_down", "diag_up"])
@pytest.mark.parametrize("winner_color", [BLACK, WHITE])
def test_win_detection_all_directions(direction, winner_color):
    n = 9
    line = {"horizontal": [_flat(n, 4, c) for c in range(5)],
            "vertical": [_flat(n, r, 4) for r in range(5)],
            "diag_down": [_flat(n, i, i) for i in range(5)],
            "diag_up": [_flat(n, 4 + i, 8 - i) for i in range(5)]}[direction]
    filler = [_flat(n, 8, 0), _flat(n, 8, 1), _flat(n, 8, 3), _flat(n, 7, 1), _flat(n, 6, 0)]
    moves = []
    for i in range(5):
        if winner_color == BLACK:
            moves += [line[i]] + ([filler[i]] if i < 4 else [])
        else:
            moves += [filler[i], line[i]]
    _, state = _play(moves)
    assert bool(state.done[0]) and int(state.winner[0]) == winner_color
    assert float(state.last_reward[0]) == 1.0


def test_six_in_a_row_wins_freestyle():
    n = 9
    moves = []
    fill = [_flat(n, 8, 0), _flat(n, 8, 1), _flat(n, 8, 3), _flat(n, 8, 4), _flat(n, 7, 0)]
    for i, c in enumerate([0, 1, 2, 3, 5]):
        moves += [_flat(n, 4, c), fill[i]]
    _, state = _play(moves)
    assert not bool(state.done[0])
    _, state = _play(moves + [_flat(n, 4, 4)])
    assert bool(state.done[0]) and int(state.winner[0]) == BLACK


def test_draw_on_full_board():
    _, state = _play(list(range(16)), n=4, k=5)  # k > n: no win possible
    assert bool(state.done[0]) and int(state.winner[0]) == 0
    assert float(state.last_reward[0]) == 0.0
    assert not bool(state.legal.any())


def test_step_after_done_is_noop():
    n = 9
    filler = [_flat(n, 8, 0), _flat(n, 8, 1), _flat(n, 8, 3), _flat(n, 8, 4)]
    moves = []
    for i in range(5):
        moves += [_flat(n, 4, i)] + ([filler[i]] if i < 4 else [])
    engine, state = _play(moves)
    assert bool(state.done[0])
    after = engine.step_batch(state, torch.tensor([_flat(n, 0, 0)], dtype=torch.int32))
    assert_tree_equal(state, after)
    assert not bool(state.legal.any())


def test_analyze_matches_jax():
    n, batch = 7, 6
    rng = np.random.RandomState(5)
    jax_engine, engine = _engines(n)
    j_states = jax_engine.init_batch(batch)
    j_states = j_states.replace(
        board=jnp.asarray(rng.choice([-1, 0, 1], size=(batch, n, n)).astype(np.int8)),
        done=jnp.asarray(np.array([False, True] * 3)))
    t_states = GameState.from_numpy(j_states)
    assert_tree_equal(jitted(jax_engine, "analyze", batched=True)(j_states),
                      engine.analyze(t_states))
