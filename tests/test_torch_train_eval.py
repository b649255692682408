"""The Trainer's evaluator hooks and ``cli.train`` with the evaluator on,
on the CPU at 5x5 Go with 1 x 8 nets and 8 simulations.

- ``cli.train`` writes the JAX package's ``evaluation.csv`` header and an
  eval SGF per checkpoint, and its Elo columns equal an ``EloRating``
  replay of the recorded results across a resume.
- The async evaluator (``run.eval_async``) writes the inline one's rows.
- A resumed Trainer's evaluator continues the Elo curve and plays its
  first checkpoint against the resumed weights.
- A failed evaluation is logged and skips its row; training goes on.
"""

import csv
import os

import numpy as np
import torch

from alpha_zero_tpu_torch.cli import train as cli_train
from alpha_zero_tpu_torch.cli.common import resolve_config
from alpha_zero_tpu_torch.eval import elo
from alpha_zero_tpu_torch.training import pipeline

from torch_parity import one_torch_thread  # noqa: F401

EVAL_HEADER = ["datetime", "training_steps", "game_length", "game_result", "num_passes",
               "black_elo_rating", "white_elo_rating"]
PRO_HEADER = ["value_mse_error", "policy_entropy", "policy_top_1_accuracy",
              "policy_top_3_accuracy", "policy_top_5_accuracy"]


def _train_args(tmp_path, *extra):
    sets = ["env.board_size=5", "env.num_stack=2", "env.max_steps=20",
            "network.num_res_blocks=1", "network.num_filters=8", "network.num_fc_units=8",
            "search.num_simulations=8", "search.max_new_sims=4",
            "parallel.selfplay_batch_size=4", "train.min_games=4", "train.games_per_ckpt=4",
            "train.batch_size=16", "train.max_training_steps=4", "train.ckpt_interval=2",
            "train.log_interval=2", "resign.check_resign_after_steps=4",
            f"run.ckpt_dir={tmp_path}/ckpt", f"run.logs_dir={tmp_path}/logs",
            f"run.save_sgf_dir={tmp_path}/sgf", "run.save_sgf_interval=0", "run.seed=5",
            *extra]
    return ["--device", "cpu", "--config", "go9"] + [x for s in sets for x in ("--set", s)]


def _eval_rows(tmp_path):
    with open(tmp_path / "logs" / "evaluation.csv") as f:
        return list(csv.DictReader(f))


def test_cli_train_evaluates_and_continues_elo_on_resume(tmp_path):
    """``cli.train`` with the evaluator on (one deterministic game a
    checkpoint), then resumed from its last checkpoint with pro metrics
    over a 5x5 corpus made of the first run's eval SGFs: the JAX package's
    ``evaluation.csv`` header, an eval SGF per checkpoint, and the Elo
    columns equal to an ``EloRating`` replay of the recorded results
    across the resume."""
    cli_train.main(_train_args(tmp_path, "run.eval_games=1"))
    corpus = tmp_path / "sgf"
    assert sorted(os.listdir(corpus)) == ["eval_training_steps_2.sgf",
                                          "eval_training_steps_4.sgf"]
    cli_train.main(_train_args(tmp_path, "run.eval_games=1", "train.max_training_steps=6",
                               f"run.load_ckpt={tmp_path}/ckpt/training_steps_4",
                               f"run.eval_games_dir={corpus}"))
    rows = _eval_rows(tmp_path)
    assert list(rows[0]) == EVAL_HEADER
    assert [int(r["training_steps"]) for r in rows] == [2, 4, 6]
    with open(tmp_path / "logs" / "evaluation.csv") as f:
        lines = f.read().splitlines()
    assert lines[-1].count(",") == len(EVAL_HEADER) + len(PRO_HEADER) - 1
    pro = [float(x) for x in lines[-1].split(",")[len(EVAL_HEADER):]]
    assert all(np.isfinite(pro)) and 0 <= pro[2] <= pro[3] <= pro[4] <= 1
    black, white = elo.EloRating(0.0), elo.EloRating(0.0)
    for row in rows:
        result = row["game_result"]
        if result.startswith("B+"):
            black.update_rating(white.rating, 1)
            white.update_rating(black.rating, 0)
        elif result.startswith("W+"):
            white.update_rating(black.rating, 1)
            black.update_rating(white.rating, 0)
        assert float(row["black_elo_rating"]) == black.rating
        assert float(row["white_elo_rating"]) == white.rating
        white = elo.EloRating(black.rating)


def _trainer(tmp_path, **run):
    args = _train_args(tmp_path, "run.eval_games=2",
                       *(f"run.{k}={v}" for k, v in run.items()))
    cfg = resolve_config("go9", args[5::2])
    trainer = pipeline.Trainer(cfg, device="cpu")
    trainer.enable_evaluator()
    return trainer


def test_async_evaluator_writes_the_rows_of_the_inline_one(tmp_path):
    """The evaluator on its worker thread (``run.eval_async``), given a copy
    of the weights at each checkpoint, writes the rows the inline evaluator
    writes: the games depend only on the weights and the step."""
    rows = []
    for mode in ("inline", "async"):
        trainer = _trainer(tmp_path / mode, eval_async=mode == "async")
        trainer.run()
        assert trainer._eval_queue is None  # the worker finished
        if mode == "async":
            assert not trainer._eval_thread.is_alive()
        rows.append([{k: v for k, v in r.items() if k != "datetime"}
                     for r in _eval_rows(tmp_path / mode)])
    assert rows[0] == rows[1] and len(rows[0]) == 2
    assert list(rows[0][0]) == EVAL_HEADER[1:] + ["eval_games", "latest_win_rate"]


def test_resumed_evaluator_plays_against_the_resumed_weights(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.run()
    resumed = _trainer(tmp_path, load_ckpt=trainer.latest_ckpt_path)
    ev = resumed.evaluator
    assert ev.has_prev and ev.black_elo.rating == ev.white_elo.rating == float(
        _eval_rows(tmp_path)[-1]["black_elo_rating"])
    master = trainer.train_state.net.state_dict()
    for name, value in ev.prev_net.state_dict().items():
        assert torch.equal(value, master[name].to(value.dtype)), name


def test_failed_evaluation_skips_its_row(tmp_path, caplog):
    trainer = _trainer(tmp_path)

    def fail(weights, seed=0):
        raise RuntimeError("planted failure")

    trainer.evaluator.evaluate = fail
    trainer.run()
    assert not (tmp_path / "logs" / "evaluation.csv").exists()
    assert trainer._eval_failures == 2
    assert "planted failure" in caplog.text
