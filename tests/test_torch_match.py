"""Parity of the port's matches (``eval/match.py``, ``cli/match.py``) with
the JAX package's.

5x5 Go with float32 2-block x 16-filter nets of two seeds (the port loads
the Flax weights), 16 simulations, eight lockstep games to their end. The
port is fed the JAX package's sampling draws, so both play the same games:
the same moves, results and lengths. Then the trained gomoku9 checkpoint
``logs/gomoku/9x9/ckpt_10000``, converted by ``tools/ckpt_to_torch.py``,
plays itself in both packages, and ``cli.match --device cpu`` writes its
``log.csv`` and SGFs, every game legal on a replay through the host env.
"""

import csv
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.eval import match as jax_match
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training import checkpoint as jax_ckpt
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu.training.pipeline import build_engine as jax_build_engine
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.cli import match as cli_match
from alpha_zero_tpu_torch.cli.play import load_variables
from alpha_zero_tpu_torch.envs.host import GoEnv
from alpha_zero_tpu_torch.eval import match
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.coords import CoordsConvertor

from torch_parity import JaxGumbels, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMES, SIMS, SEED = 8, 16, 11


def _configs(lib):
    env = lib.EnvConfig(game="go", board_size=5, num_stack=2, max_steps=24)
    net = lib.NetworkConfig(num_res_blocks=2, num_filters=16, num_fc_units=16,
                            inference_dtype="float32")
    search = lib.SearchConfig(num_simulations=SIMS)
    return env, net, search


@pytest.fixture(scope="module")
def nets():
    """(JAX engine, Flax net, black and white variables, the port's engine
    and the two nets with the same weights)."""
    env, net_cfg, _ = _configs(jax_config)
    flax_net = jax_build_network(env, net_cfg)
    obs = jnp.zeros((1, 5, 5, env.num_planes), jnp.int8)
    variables = [flax_net.init(jax.random.PRNGKey(seed), obs, train=False)
                 for seed in (3, 4)]
    env_t, net_cfg_t, _ = _configs(config_lib)
    port = []
    for v in variables:
        net = build_network(env_t, net_cfg_t, device="cpu")
        net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, v)))
        port.append(net)
    return jax_build_engine(env), flax_net, variables, build_engine(env_t), port


def _assert_same_games(ref, out):
    assert len(ref) == len(out) == GAMES
    for r, o in zip(ref, out):
        assert [tuple(m) for m in r.pop("moves")] == [tuple(m) for m in o.pop("moves")]
        assert r == o


def test_play_matches_same_games_as_jax(nets):
    jax_engine, flax_net, (vb, vw), engine, (black, white) = nets
    _, _, search = _configs(jax_config)
    ref = jax_match.play_matches(jax_engine, flax_net, search, vb, vw, num_games=GAMES,
                                 seed=SEED, record_moves=True)
    out = match.play_matches(engine, _configs(config_lib)[2], black, white, num_games=GAMES,
                             record_moves=True, device="cpu",
                             draws=JaxGumbels(SEED, GAMES, engine.num_actions))
    results = {r["game_result"] for r in out}
    _assert_same_games(ref, out)
    assert len(results) > 1  # the games differ


def test_play_matches_asym_with_reuse_same_games_as_jax(nets):
    """Black reuses its subtrees at ``max_new_sims=8``, white searches fresh
    trees: both sides' trees are re-rooted every ply."""
    jax_engine, flax_net, (vb, vw), engine, (black, white) = nets
    sides = []
    for lib in (jax_config, config_lib):
        search = _configs(lib)[2]
        sides.append((dataclasses.replace(search, reuse_subtree=True, max_new_sims=8),
                      search))
    ref = jax_match.play_matches_asym(jax_engine, flax_net, *sides[0], vb, vw,
                                      num_games=GAMES, seed=SEED + 1, record_moves=True)
    out = match.play_matches_asym(engine, *sides[1], black, white, num_games=GAMES,
                                  record_moves=True, device="cpu",
                                  draws=JaxGumbels(SEED + 1, GAMES, engine.num_actions))
    _assert_same_games(ref, out)


def _replay_is_legal(moves, result, komi=7.5):
    """Replays ``moves`` through the port's host GoEnv: strict B/W
    alternation, every move legal, no move after the end; returns the
    env's result string, which must equal ``result`` once the game ended."""
    env = GoEnv(board_size=5, komi=komi, num_stack=2, max_steps=24, device="cpu")
    for i, (color, move) in enumerate(moves):
        assert color == ("B" if i % 2 == 0 else "W")
        assert not env.is_game_over() and env.is_legal_move(move)
        env.step(move)
    assert env.is_game_over()
    assert env.get_result_string() == result


def test_match_games_replay_legally(nets):
    _, _, _, engine, (black, white) = nets
    stats = match.play_matches(engine, _configs(config_lib)[2], black, white,
                               num_games=GAMES, seed=2, record_moves=True, device="cpu")
    for game in stats:
        assert len(game["moves"]) == game["game_length"]
        _replay_is_legal(game["moves"], game["game_result"])


def test_gomoku9_checkpoint_plays_itself_as_in_jax(tmp_path):
    """``ckpt_10000`` through ``tools/ckpt_to_torch.py --config gomoku9``,
    float32, 16 simulations, two games against itself in both packages."""
    spec = importlib.util.spec_from_file_location(
        "ckpt_to_torch", os.path.join(REPO, "tools", "ckpt_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ckpt = os.path.join(REPO, "logs", "gomoku", "9x9", "ckpt_10000")
    path = tool.main(["--ckpt", ckpt, "--config", "gomoku9", "--out", str(tmp_path)])

    def f32(lib):
        cfg = lib.gomoku9()
        return dataclasses.replace(
            cfg, network=dataclasses.replace(cfg.network, inference_dtype="float32"),
            search=dataclasses.replace(cfg.search, num_simulations=SIMS))

    jcfg = f32(jax_config)
    n = jcfg.env.board_size
    tx, _ = jax_learner.make_optimizer(
        jcfg.train.init_lr, jcfg.train.lr_decay, jcfg.train.lr_milestones,
        momentum=jcfg.train.sgd_momentum, weight_decay=jcfg.train.l2_regularization)
    flax_net = jax_build_network(jcfg.env, jcfg.network)
    template = jax_learner.create_train_state(flax_net, jax.random.PRNGKey(0),
                                              (n, n, jcfg.env.num_planes), tx)
    state = jax_ckpt.restore_checkpoint(ckpt, template)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    ref = jax_match.play_matches(jax_build_engine(jcfg.env), flax_net, jcfg.search,
                                 variables, variables, num_games=2, seed=5,
                                 record_moves=True)

    cfg = f32(config_lib)
    engine = build_engine(cfg.env)
    net = load_variables(cfg, path, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 337066
    out = match.play_matches(engine, cfg.search, net, net, num_games=2, record_moves=True,
                             device="cpu", draws=JaxGumbels(5, 2, engine.num_actions))
    for r, o in zip(ref, out):
        assert [tuple(m) for m in r.pop("moves")] == [tuple(m) for m in o.pop("moves")]
        assert r == o
    assert all(g["game_result"] in ("B+1.0", "W+1.0") for g in out)  # trained: wins


def test_cli_match_writes_log_and_sgfs(tmp_path):
    cfg = config_lib.go9()
    sets = ["env.board_size=5", "env.num_stack=2", "env.max_steps=20",
            "network.num_res_blocks=1", "network.num_filters=8", "network.num_fc_units=8",
            "search.num_simulations=8"]
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, board_size=5, num_stack=2, max_steps=20),
        network=dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8,
                                    num_fc_units=8))
    paths = []
    for seed in (1, 2):
        net = build_network(cfg.env, cfg.network, device="cpu", seed=seed, dtype="float32")
        state = learner.create_train_state(net, cfg.train)
        paths.append(ckpt_lib.save_checkpoint(str(tmp_path), state, seed))
    out_dir = tmp_path / "matches"
    cli_match.main(["--device", "cpu", "--config", "go9", "--black_ckpt", paths[0],
                    "--white_ckpt", paths[1], "--num_games", "3", "--seed", "4",
                    "--save_match_dir", str(out_dir)]
                   + [x for s in sets for x in ("--set", s)])
    with open(out_dir / "log.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["datetime", "black", "white", "game", "game_result",
                             "game_length"]
    assert [int(r["game"]) for r in rows] == [0, 1, 2]
    cc = CoordsConvertor(5)
    for row in rows:
        assert row["black"] == paths[0] and row["white"] == paths[1]
        game = sgf_lib.parse_sgf((out_dir / f"game_{row['game']}.sgf").read_text())
        assert game.result == row["game_result"] and game.board_size == 5
        moves = [(c, cc.to_flat(cc.from_sgf(m))) for c, m in game.moves]
        assert len(moves) == int(row["game_length"])
        env = GoEnv(board_size=5, komi=cfg.env.komi, num_stack=2, max_steps=20,
                    device="cpu")
        for color, move in moves:
            assert env.get_player_name_by_id(env.to_play) == color
            env.step(move)
        assert env.get_result_string() == row["game_result"]
        assert re.match(r"[BW]\+|DRAW", row["game_result"])
