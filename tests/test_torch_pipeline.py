"""The port's training pipeline against the JAX package's, on the CPU.

- ``ResignController`` and ``maybe_adjust_resign_threshold`` driven through
  the cases of ``tests/test_resign_controller.py`` side by side with the
  JAX package's: the same threshold and counters after every game.
- ``make_sgf`` / ``parse_sgf`` and the CSV writer: identical strings and
  files.
- Micro Trainer runs (``tests/test_pipeline.py``): end-to-end training on
  5x5 Gomoku, resume from a checkpoint, resign-threshold continuity, a
  checkpoint restored bit-equal to the Trainer's state.
- ``cli.train``: runs to its step budget with ``--device cpu --no-eval``,
  writes the JAX package's CSV headers and restorable checkpoints, resumes
  from one, and runs the evaluator unless ``--no-eval``.
"""

import copy
import csv
import dataclasses
import logging
import os

import pytest
import torch

from alpha_zero_tpu.config import ResignConfig as JaxResignConfig
from alpha_zero_tpu.training.pipeline import ResignController as JaxResignController
from alpha_zero_tpu.training.pipeline import \
    maybe_adjust_resign_threshold as jax_maybe_adjust
from alpha_zero_tpu.utils import sgf as jax_sgf
from alpha_zero_tpu.utils.csv_writer import CsvWriter as JaxCsvWriter
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.cli import train as cli_train
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner, pipeline
from alpha_zero_tpu_torch.utils import sgf
from alpha_zero_tpu_torch.utils.csv_writer import CsvWriter

from torch_parity import one_torch_thread  # noqa: F401

LOGGER = logging.getLogger("test")
TRAINING_HEADER = ["datetime", "training_steps", "policy_loss", "value_loss",
                   "learning_rate", "total_games", "total_samples"]

# ---------------------------------------------------------------------------
# Resign controller
# ---------------------------------------------------------------------------


def _marked(could_won):
    return {"is_resign_disabled": True, "is_marked_for_resign": True,
            "is_could_won": could_won}


_UNMARKED = {"is_resign_disabled": False, "is_marked_for_resign": False,
             "is_could_won": False}

# Scripted (stats, num_games_added) streams of tests/test_resign_controller.py.
_STREAMS = {
    "disabled_until_no_resign_games": [(_marked(True), n) for n in range(1, 11)],
    "tightens_on_high_fp_rate": [(_marked(True), 10)]
    + [(_marked(i % 2 == 0), 11 + i) for i in range(8)],
    "no_adjustment_below_target": [(_marked(True), 10)]
    + [(_marked(False), 11 + i) for i in range(8)],
    "unmarked_games_do_not_count": [(_marked(True), 10)]
    + [(_UNMARKED, 11 + i) for i in range(20)],
    "periodic_hard_reset": [(_marked(True), n) for n in range(10, 41)],
}


@pytest.mark.parametrize("stream", sorted(_STREAMS))
@pytest.mark.parametrize("init,no_resign", [(-0.88, 10), (-1.0, 0)])
def test_resign_controller_matches_jax(stream, init, no_resign):
    kw = dict(init_resign_threshold=init, check_resign_after_steps=1, target_fp_rate=0.05,
              disable_resign_ratio=0.1, reset_fp_interval=40, no_resign_games=no_resign)
    ref = JaxResignController(JaxResignConfig(**kw), games_per_ckpt=320, logger=LOGGER)
    ours = pipeline.ResignController(config_lib.ResignConfig(**kw), games_per_ckpt=320,
                                     logger=LOGGER)
    fields = ("threshold", "resign_count", "last_resign_count", "could_won_count")
    assert [getattr(ref, f) for f in fields] == [getattr(ours, f) for f in fields]
    for stats, n in _STREAMS[stream]:
        ref.on_game(dict(stats), n)
        ours.on_game(dict(stats), n)
        assert [getattr(ref, f) for f in fields] == [getattr(ours, f) for f in fields]
    if stream == "tightens_on_high_fp_rate" and init > -1.0:
        assert ours.threshold == -0.9999


@pytest.mark.parametrize("rate", [0.0, 0.04, 0.05, 0.1, 0.3, 1.0])
@pytest.mark.parametrize("current", [-0.5, -0.88, -0.99])
def test_maybe_adjust_matches_jax(rate, current):
    assert pipeline.maybe_adjust_resign_threshold(current, rate, 0.05) == jax_maybe_adjust(
        current, rate, 0.05)


# ---------------------------------------------------------------------------
# SGF and CSV
# ---------------------------------------------------------------------------


def test_make_sgf_matches_jax():
    from collections import namedtuple

    pm = namedtuple("PlayerMove", ["color", "move"])
    moves = [pm("B" if i % 2 == 0 else "W", m) for i, m in
             enumerate([40, 30, 81, 12, 0, 80, 81, 44, 3, 5, 7, 9, 11])]
    kw = dict(board_size=9, move_history=moves, result_string="B+3.5", ruleset="Chinese",
              komi=7.5, date="2026-01-01", comments=["x]y", None, "z"])
    text = sgf.make_sgf(**kw)
    assert text == jax_sgf.make_sgf(**kw)
    game = sgf.parse_sgf(text)
    ref = jax_sgf.parse_sgf(text)
    assert (game.props, game.moves) == (ref.props, ref.moves)
    assert game.board_size == 9 and game.result == "B+3.5" and len(game.moves) == 13
    assert sgf.parse_game_result("W+R") == jax_sgf.parse_game_result("W+R") == -1


def test_csv_rows_match_jax(tmp_path):
    rows = [{"datetime": "2026-01-01 00:00:00", "game_length": 31, "game_result": "B+1.0",
             "num_passes": 2, "resign_threshold": -0.88, "time_per_game": 0.1234},
            {"datetime": "2026-01-01 00:00:01", "game_length": 12, "game_result": "DRAW",
             "num_passes": 0, "resign_threshold": -1.0, "time_per_game": 0.5}]
    for cls, name in ((CsvWriter, "ours.csv"), (JaxCsvWriter, "ref.csv")):
        writer = cls(str(tmp_path / name), buffer_size=1)
        for row in rows:
            writer.write(row)
        writer.close()
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()


# ---------------------------------------------------------------------------
# Micro Trainer runs
# ---------------------------------------------------------------------------


def micro_config(tmp_path):
    return config_lib.AlphaZeroConfig(
        env=config_lib.EnvConfig(game="gomoku", board_size=5, num_stack=2, num_to_win=3),
        network=config_lib.NetworkConfig(num_res_blocks=1, num_filters=8, num_fc_units=8,
                                         gomoku=True),
        search=config_lib.SearchConfig(num_simulations=8, warm_up_steps=2),
        resign=config_lib.ResignConfig(init_resign_threshold=-1.0),
        train=config_lib.TrainConfig(
            min_games=6, games_per_ckpt=4, replay_capacity=4096, batch_size=16,
            max_training_steps=6, ckpt_interval=3, log_interval=3,
            init_lr=0.01, lr_milestones=(1000,),
        ),
        run=config_lib.RunConfig(
            ckpt_dir=str(tmp_path / "ckpt"), logs_dir=str(tmp_path / "logs"),
            save_sgf_dir=str(tmp_path / "sgf"), save_sgf_interval=3, seed=3,
        ),
        parallel=config_lib.ParallelConfig(selfplay_batch_size=4),
    )


def _fresh_state(cfg):
    net = build_network(cfg.env, cfg.network, device="cpu", dtype="float32")
    return learner.create_train_state(net, cfg.train)


def test_end_to_end_micro_training(tmp_path):
    cfg = micro_config(tmp_path)
    snapshots = {}

    def on_checkpoint(trainer):
        snapshots[trainer.training_steps] = copy.deepcopy(trainer.train_state)
        # The self-play net holds the new master weights, cast to its dtype.
        master = trainer.train_state.net.state_dict()
        for name, value in trainer.play_net.state_dict().items():
            assert torch.equal(value, master[name].to(value.dtype)), name

    trainer = pipeline.train(cfg, device="cpu", on_checkpoint=on_checkpoint)
    assert trainer.training_steps == 6 and sorted(snapshots) == [3, 6]
    assert trainer.replay.num_games_added >= 10
    assert trainer.replay.size == trainer.replay.num_samples_added > 0

    with open(os.path.join(cfg.run.logs_dir, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == TRAINING_HEADER
    assert [int(r["training_steps"]) for r in rows] == [3, 6]
    with open(os.path.join(cfg.run.logs_dir, "actor0.csv")) as f:
        actor = list(csv.DictReader(f))
    assert list(actor[0]) == ["datetime", "game_length", "game_result", "time_per_game",
                              "training_steps"]
    assert sum(int(r["game_length"]) for r in actor) == trainer.replay.num_samples_added

    latest = ckpt_lib.latest_checkpoint(cfg.run.ckpt_dir)
    assert latest == trainer.latest_ckpt_path and ckpt_lib.checkpoint_step(latest) == 6
    for step in (3, 6):
        restored = ckpt_lib.restore_checkpoint(
            os.path.join(cfg.run.ckpt_dir, f"training_steps_{step}"), _fresh_state(cfg))
        assert ckpt_lib.states_equal(snapshots[step], restored)

    sgf_files = sorted(os.listdir(cfg.run.save_sgf_dir))
    assert sgf_files
    with open(os.path.join(cfg.run.save_sgf_dir, sgf_files[0])) as f:
        game = sgf.parse_sgf(f.read())
    assert game.board_size == 5 and len(game.moves) > 0


def test_resume_from_checkpoint(tmp_path):
    cfg = micro_config(tmp_path)
    trainer = pipeline.train(cfg, device="cpu")
    cfg2 = dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, load_ckpt=trainer.latest_ckpt_path),
        train=dataclasses.replace(cfg.train, max_training_steps=9))
    trainer2 = pipeline.Trainer(cfg2, device="cpu")
    assert trainer2.training_steps == 6
    assert ckpt_lib.states_equal(trainer.train_state, trainer2.train_state)
    trainer2.run()
    assert trainer2.training_steps == 9


def test_resign_threshold_continuity_across_resume(tmp_path):
    cfg = micro_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        env=config_lib.EnvConfig(game="go", board_size=5, num_stack=2),
        resign=config_lib.ResignConfig(init_resign_threshold=-0.88, no_resign_games=2,
                                       check_resign_after_steps=4),
        train=dataclasses.replace(cfg.train, min_games=4, games_per_ckpt=3,
                                  save_replay_interval=2),
    )
    trainer = pipeline.train(cfg, device="cpu")
    assert trainer.resign_controller.threshold > -1.0  # the crossing fired live
    cfg2 = dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, load_ckpt=trainer.latest_ckpt_path,
                                load_replay=trainer._replay_path),
        train=dataclasses.replace(cfg.train, max_training_steps=9),
    )
    trainer2 = pipeline.Trainer(cfg2, device="cpu")
    assert trainer2.replay.num_games_added >= cfg.resign.no_resign_games
    assert trainer2.resign_controller.threshold == trainer.resign_controller.threshold


def test_multi_device_training_is_not_ported(tmp_path):
    """Data and model parallelism run only across the ranks of a process
    group (``tests/test_torch_multihost.py``,
    ``tests/test_torch_model_axis.py``): a Trainer built in one process for
    mdl=2, dp=2 or a coordinator raises, naming both layouts."""
    cfg = micro_config(tmp_path)
    for parallel, want in ((dict(mdl=2), "dp=1, mdl=2"), (dict(dp=2), "dp=2, mdl=1"),
                           (dict(coordinator_address="localhost:1234", num_processes=2),
                            "dp=2, mdl=1")):
        bad = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **parallel))
        with pytest.raises(RuntimeError, match=rf"asks for Mesh\({want}\) and the process "
                                               r"group has Mesh\(dp=1, mdl=1\)"):
            pipeline.Trainer(bad, device="cpu")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli_args(tmp_path, *extra):
    sets = ["env.board_size=5", "env.num_stack=2", "network.num_res_blocks=1",
            "network.num_filters=8", "network.num_fc_units=8", "search.num_simulations=8",
            "search.max_new_sims=4", "parallel.selfplay_batch_size=4",
            "train.min_games=4", "train.games_per_ckpt=4", "train.batch_size=16",
            "train.max_training_steps=4", "train.ckpt_interval=2", "train.log_interval=1",
            "resign.check_resign_after_steps=4", f"run.ckpt_dir={tmp_path}/ckpt",
            f"run.logs_dir={tmp_path}/logs", "run.seed=5", *extra]
    return ["--device", "cpu", "--config", "go9", "--no-eval"] + [
        x for s in sets for x in ("--set", s)]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    cli_train.main(_cli_args(tmp_path))
    cfg = config_lib.go9()
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, board_size=5, num_stack=2),
                              network=dataclasses.replace(cfg.network, num_res_blocks=1,
                                                          num_filters=8, num_fc_units=8))
    for step in (2, 4):
        state = ckpt_lib.restore_checkpoint(str(tmp_path / "ckpt" / f"training_steps_{step}"),
                                            _fresh_state(cfg))
        assert state.training_steps == step
    with open(tmp_path / "logs" / "actor0.csv") as f:
        header = next(csv.reader(f))
    assert header == ["datetime", "game_length", "game_result", "num_passes",
                      "is_resign_disabled", "is_marked_for_resign", "is_could_won",
                      "marked_resign_player", "resign_threshold", "time_per_game",
                      "training_steps"]

    cli_train.main(_cli_args(tmp_path, f"run.load_ckpt={tmp_path}/ckpt/training_steps_4",
                             "train.max_training_steps=6"))
    with open(tmp_path / "logs" / "training.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == TRAINING_HEADER
    assert [int(r["training_steps"]) for r in rows] == [1, 2, 3, 4, 5, 6]
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ckpt")).endswith("training_steps_6")


def test_cli_refuses_to_run_without_no_eval(tmp_path):
    """``--no-eval`` is optional now: without it ``cli.train`` does not
    refuse but trains with the evaluator, one ``evaluation.csv`` row per
    checkpoint; with it there is no such file."""
    cli_train.main(_cli_args(tmp_path))
    assert not (tmp_path / "logs" / "evaluation.csv").exists()
    args = [a for a in _cli_args(tmp_path / "eval", "run.eval_games=2") if a != "--no-eval"]
    cli_train.main(args)
    with open(tmp_path / "eval" / "logs" / "evaluation.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["training_steps"]) for r in rows] == [2, 4]
