"""Parity of the port's host envs (``envs/host.py``) with the JAX package's.

In-repo SGF games (9x9 Go from ``logs/go/9x9_matched/sgf`` and
``logs/go/9x9/sgf``, 9x9 Gomoku from ``logs/gomoku/9x9/sgf``) are replayed
move by move through both packages' envs; after every move the board,
legal mask, player to move, captures, CHW observation, reward, done flag,
winner and result string are equal, and at the end the rendered board and
the ``to_sgf`` body (all but its date) are too.
"""

import os
import re

import numpy as np
import pytest

from alpha_zero_tpu.envs import host as jax_host
from alpha_zero_tpu_torch.envs import host
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.coords import CoordsConvertor

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(REPO, "logs")


def _sgf_files(path, count):
    files = sorted(os.listdir(os.path.join(LOGS, path)))
    return [os.path.join(path, f) for f in files[:count]]


GO_GAMES = _sgf_files("go/9x9_matched/sgf", 3) + _sgf_files("go/9x9/sgf", 2)
GOMOKU_GAMES = _sgf_files("gomoku/9x9/sgf", 3)


def _moves(path):
    game = sgf_lib.parse_sgf(open(os.path.join(LOGS, path)).read())
    cc = CoordsConvertor(game.board_size)
    return game, [(c, cc.to_flat(cc.from_sgf(m))) for c, m in game.moves]


def _without_date(sgf):
    return re.sub(r"DT\[[^\]]*\]", "", sgf)


def _assert_same(ref, env):
    np.testing.assert_array_equal(ref.board, env.board)
    np.testing.assert_array_equal(ref.legal_actions, env.legal_actions)
    np.testing.assert_array_equal(ref.observation(), env.observation())
    assert (ref.to_play, ref.winner, ref.steps) == (env.to_play, env.winner, env.steps)
    assert ref.is_game_over() == env.is_game_over()
    assert ref.get_result_string() == env.get_result_string()
    if hasattr(ref, "get_captures"):
        assert ref.get_captures() == env.get_captures()


def _replay(ref, env, moves):
    _assert_same(ref, env)
    for color, move in moves:
        if ref.is_game_over():
            break
        assert ref.get_player_name_by_id(ref.to_play) == color
        assert env.get_player_name_by_id(env.to_play) == color
        _, r_reward, r_done, _ = ref.step(move)
        obs, reward, done, _ = env.step(move)
        assert (r_reward, r_done) == (reward, done)
        assert obs.shape == (env.num_stack * 2 + 1, env.board_size, env.board_size)
        _assert_same(ref, env)
    assert _without_date(ref.to_sgf()) == _without_date(env.to_sgf())
    assert ref.render("ansi").getvalue() == env.render("ansi").getvalue()
    assert ref.history == env.history


@pytest.mark.parametrize("path", GO_GAMES)
def test_go_env_replays_sgf_like_jax(path):
    game, moves = _moves(path)
    komi = game.komi or 0.0
    ref = jax_host.GoEnv(board_size=9, komi=komi, num_stack=8)
    env = host.GoEnv(board_size=9, komi=komi, num_stack=8, device="cpu")
    _replay(ref, env, moves)
    assert env.is_game_over()
    assert env.get_result_string() == game.result  # the recorded result


@pytest.mark.parametrize("path", GOMOKU_GAMES)
def test_gomoku_env_replays_sgf_like_jax(path):
    game, moves = _moves(path)
    ref = jax_host.GomokuEnv(board_size=9, num_to_win=5, num_stack=8)
    env = host.GomokuEnv(board_size=9, num_to_win=5, num_stack=8, device="cpu")
    _replay(ref, env, moves)
    assert env.is_game_over() and env.get_result_string() == game.result


def test_go_env_resign_and_gtp_like_jax():
    """Resign, GTP and coordinate conversions, an unfinished game's result,
    the bound checks of ``step``."""
    ref = jax_host.GoEnv(board_size=5, komi=0.5, num_stack=2)
    env = host.GoEnv(board_size=5, komi=0.5, num_stack=2, device="cpu")
    for gtp in ("C3", "D4", "pass", "E5", "Z9", "A1"):
        assert ref.gtp_to_action(gtp) == env.gtp_to_action(gtp)
    for action in (0, 12, 24, 25):
        assert ref.action_to_gtp(action) == env.action_to_gtp(action)
        assert ref.action_to_coords(action) == env.action_to_coords(action)
    assert ref.coords_to_action((2, 3)) == env.coords_to_action((2, 3))
    assert ref.coords_to_action((5, 0)) == env.coords_to_action((5, 0)) is None
    for move in (12, 7):
        ref.step(move)
        env.step(move)
    _assert_same(ref, env)  # an unfinished game scores its board
    with pytest.raises(ValueError, match="Illegal"):
        env.step(12)
    with pytest.raises(ValueError, match="out of bound"):
        env.step(26)
    ref.step(ref.resign_move)
    env.step(env.resign_move)
    _assert_same(ref, env)
    assert env.get_result_string() == "W+R"  # black, to play, resigned
    with pytest.raises(RuntimeError, match="Game is over"):
        env.step(0)
    env.reset()
    assert env.steps == 0 and env.history == [] and not env.is_game_over()


def test_single_game_engine_helpers():
    """``init``/``step``/``area_score``: a batch of 1 through the batched
    engine."""
    engine = GoEngine(board_size=5, num_stack=2, komi=0.5)
    state = engine.init("cpu")
    assert state.board.shape == (1, 5, 5)
    for move in (12, 25, 25):
        state = engine.step(state, move)
    assert bool(state.done[0]) and int(state.step_count[0]) == 3
    # Black's one stone owns the whole board: area 25, score 25 - komi.
    assert float(engine.area_score(state.board)[0]) == 25.0
    assert float(state.final_score[0]) == 24.5
