"""The checkpoint backfill evaluator
(``alpha_zero_tpu_torch/tools/backfill_eval.py``) against the JAX tool
``tools/backfill_eval.py``.

Three checkpoints (steps 10, 20, 30) come from three Flax inits of a float32
2-block x 16-filter go9 net with randomized BatchNorm terms. Each is saved
as the JAX package's orbax ``training_steps_*`` and, through
``train_state_from_flax``, as the port's. The pro games are three games of
``logs/go/9x9_matched/sgf``; the search runs 16 simulations, and the eval
games end at 10 moves. The JAX tool runs unchanged on the CPU on that
config (it stands in for ``get_config``'s). Its CSV and the port's
(``--device cpu``) are equal in every column but ``datetime`` under
``--eval-games 1`` and ``--metrics-only``: exact, apart from the policy
entropy and value error, float32 sums in another order, within a relative
1e-5 (as ``tests/test_torch_eval.py`` holds them). ``--steps`` picks the
same rows in both, a ``training_steps_20.tmp`` that a crash left
mid-write is skipped, and an empty directory returns 1 in both.
"""

import csv
import dataclasses
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training import checkpoint as jax_ckpt
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.tools import backfill_eval
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib

from torch_parity import flax_variables, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRO_GAMES = os.path.join(REPO, "logs", "go", "9x9_matched", "sgf")
STEPS = (10, 20, 30)
SUMS = ("value_mse_error", "policy_entropy")  # float32 sums: rel 1e-5


def _tiny(lib):
    cfg = lib.go9()
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_steps=10),
        network=dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                    num_fc_units=16, inference_dtype="float32"),
        search=dataclasses.replace(cfg.search, num_simulations=16))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two packages' checkpoint directories and the pro games."""
    root = tmp_path_factory.mktemp("backfill")
    cfg = _tiny(jax_config)
    net = jax_build_network(cfg.env, cfg.network)
    tx, _ = jax_learner.make_optimizer(
        cfg.train.init_lr, cfg.train.lr_decay, cfg.train.lr_milestones,
        momentum=cfg.train.sgd_momentum, weight_decay=cfg.train.l2_regularization)
    shape = (9, 9, cfg.env.num_planes)
    port_cfg = _tiny(config_lib)
    for seed, step in enumerate(STEPS, start=1):
        variables = flax_variables(net, np.zeros((1,) + shape, np.int8), seed)
        state = jax_learner.create_train_state(net, jax.random.PRNGKey(seed), shape, tx)
        state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                              training_steps=jnp.int32(step))
        jax_ckpt.save_checkpoint(str(root / "jax"), state, step)
        np_tree = jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "training_steps": state.training_steps})
        ckpt_lib.save_checkpoint(str(root / "port"), ckpt_lib.train_state_from_flax(
            np_tree, port_cfg.env, port_cfg.network, port_cfg.train, device="cpu"), step)
    # What a crash between torch.save and os.replace leaves behind.
    shutil.copy(root / "port" / "training_steps_20", root / "port" / "training_steps_20.tmp")
    games = root / "games"
    games.mkdir()
    for name in sorted(os.listdir(PRO_GAMES))[:3]:
        shutil.copy(os.path.join(PRO_GAMES, name), games / name)
    return root


@pytest.fixture
def tools(monkeypatch):
    """``(jax_main, port_main)``, each taking the same flags (the port's
    with ``--device cpu``), on the tiny config."""
    spec = importlib.util.spec_from_file_location(
        "jax_backfill_eval", os.path.join(REPO, "tools", "backfill_eval.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(jax_config, "get_config", lambda name: _tiny(jax_config))
    monkeypatch.setattr(config_lib, "get_config", lambda name: _tiny(config_lib))
    monkeypatch.setenv("JAX_CACHE_DIR", "")  # the tests' compilation cache stays

    def jax_main(args):
        monkeypatch.setattr("sys.argv", ["backfill_eval.py", "--config", "go9"] + args)
        return tool.main()

    def port_main(args):
        return backfill_eval.main(["--config", "go9", "--device", "cpu"] + args)
    return jax_main, port_main


def _rows(path):
    with open(path) as f:
        header, *rows = csv.reader(f)
    return header, [dict(zip(header, row)) for row in rows]


def _assert_same_csv(jax_csv, port_csv, steps):
    header, rows = _rows(jax_csv)
    port_header, port_rows = _rows(port_csv)
    assert port_header == header
    assert [int(r["training_steps"]) for r in rows] == list(steps)
    for ref, out in zip(rows, port_rows, strict=True):
        for key in header[1:]:
            if key in SUMS:
                assert float(out[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
            else:
                assert out[key] == ref[key], (key, ref["training_steps"])


def test_rows_equal_the_jax_tools(run, tools, tmp_path):
    for name, extra in (("games", ["--eval-games", "1"]), ("metrics", ["--metrics-only"])):
        outs = []
        for main, sub in zip(tools, ("jax", "port")):
            out = str(tmp_path / f"{sub}_{name}.csv")
            assert main(["--ckpt-dir", str(run / sub), "--eval-games-dir",
                         str(run / "games"), "--out", out] + extra) == 0
            outs.append(out)
        _assert_same_csv(*outs, STEPS)
    header, rows = _rows(tmp_path / "port_games.csv")
    assert header == ["datetime", "training_steps", "game_length", "game_result",
                      "num_passes", "black_elo_rating", "white_elo_rating",
                      "value_mse_error", "policy_entropy", "policy_top_1_accuracy",
                      "policy_top_3_accuracy", "policy_top_5_accuracy"]
    assert len({r["black_elo_rating"] for r in rows}) > 1  # the Elo chain moved
    # The port's dataset cache is the Trainer's.
    assert os.path.exists(run / "port" / "eval_dataset_9x9.npz")


def test_steps_pick_the_same_rows(run, tools, tmp_path):
    outs = []
    for main, sub in zip(tools, ("jax", "port")):
        out = str(tmp_path / f"{sub}.csv")
        assert main(["--ckpt-dir", str(run / sub), "--eval-games-dir", str(run / "games"),
                     "--out", out, "--metrics-only", "--steps", "30", "10", "40"]) == 0
        outs.append(out)
    _assert_same_csv(*outs, (10, 30))


def test_empty_directory_returns_1(tools, tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    for main in tools:
        assert main(["--ckpt-dir", str(tmp_path / "empty"),
                     "--out", str(tmp_path / "x.csv")]) == 1
        assert capsys.readouterr().out == "no checkpoints found\n"
    assert not os.path.exists(tmp_path / "x.csv")
