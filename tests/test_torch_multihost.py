"""The port's data-parallel Trainer on the CPU: 2-rank runs through
``cli.train.main`` (gloo), each in a process group of its own with a
timeout, so a hang fails one test.

- ``parallel.dp=2``: ``cli.train`` spawns the two ranks, which split the
  game batch; with the evaluator on. Per-rank ``actor{r}.csv`` and
  ``replay_state_p{r}.npz``; one checkpoint per generation, which a single
  process restores and resumes from; both ranks leave every self-play
  phase on the same step with the same global game count; equal
  ``training_steps``, bit-equal train states and self-play nets; the
  evaluator on rank 0 only, one ``evaluation.csv`` row per checkpoint;
  ``training.csv`` counts every rank's games.
- A coordinator address: two ``cli.train`` processes, ranks 0 and 1 of 2,
  each with its own games, resuming a single-process checkpoint.
- ``Trainer.profile`` writes a Chrome trace naming the self-play and
  train ops.
- A model axis that does not divide the ranks raises ``ValueError``, as
  JAX's ``make_mesh`` does, and a Trainer asked for ``parallel.mdl=2``
  outside such a process group refuses to start (the model axis itself
  runs in ``tests/test_torch_model_axis.py``).

The micro sizes are ``tests/test_parallel.py:140``'s (5x5 Gomoku, 3 to
win, 1 block x 8 filters, 8 simulations), with ``mdl=1``.
"""

import csv
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from alpha_zero_tpu_torch.cli import train as cli_train
from alpha_zero_tpu_torch.cli.common import resolve_config
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner, pipeline

from torch_parity import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RUN_TIMEOUT_S = 120


def _sets(tmp_path, *extra):
    """gomoku9 cut to the micro sizes, with ``extra`` overrides."""
    return ["env.board_size=5", "env.num_stack=2", "env.num_to_win=3",
            "network.num_res_blocks=1", "network.num_filters=8", "network.num_fc_units=8",
            "search.num_simulations=8", "search.max_new_sims=4", "search.warm_up_steps=2",
            "resign.init_resign_threshold=-1.0", "train.min_games=4", "train.games_per_ckpt=4",
            "train.batch_size=16", "train.max_training_steps=4", "train.ckpt_interval=2",
            "train.log_interval=1", "train.save_replay_interval=1",
            "train.replay_capacity=2048", f"run.ckpt_dir={tmp_path}/ckpt",
            f"run.logs_dir={tmp_path}/logs", "run.eval_games=2", "run.seed=5", *extra]


def _argv(sets, evaluate=True):
    return (["--device", "cpu", "--config", "gomoku9"] + ([] if evaluate else ["--no-eval"])
            + [x for s in sets for x in ("--set", s)])


def _fresh_state():
    cfg = resolve_config("gomoku9", _sets("unused"))
    net = build_network(cfg.env, cfg.network, device="cpu", dtype="float32")
    return learner.create_train_state(net, cfg.train)


def _restore(path):
    return ckpt_lib.restore_checkpoint(str(path), _fresh_state())


def _launch(argv):
    """``cli.train.main(argv, prepare=torch_dp_ranks.record_trainer)`` in a
    new process (and process group, so its spawned ranks go with it)."""
    code = ("import sys, torch_dp_ranks\n"
            "from alpha_zero_tpu_torch.cli import train\n"
            f"train.main({argv!r}, prepare=torch_dp_ranks.record_trainer)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _wait(procs):
    """Waits for every process; kills all of them (and their ranks) if one
    fails or the run outlasts ``RUN_TIMEOUT_S``. Returns their outputs."""
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert outs is not None, f"the run outlasted {RUN_TIMEOUT_S} s"
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _rank_summaries(tmp_path, world=2):
    out = []
    for r in range(world):
        with open(tmp_path / "logs" / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _check_ranks_agree(tmp_path, generations):
    """Both ranks: the same exits from self-play (step, games, global count),
    4 training steps, bit-equal train states and self-play nets; the
    checkpoints at steps 2 and 4, the last one their state."""
    s0, s1 = _rank_summaries(tmp_path)
    assert (s0["rank"], s1["rank"], s0["world"], s1["world"]) == (0, 1, 2, 2)
    assert s0["training_steps"] == s1["training_steps"] == 4
    assert s0["exits"] == s1["exits"] and len(s0["exits"]) == generations
    assert s0["global_games_added"] == s1["global_games_added"]
    assert s0["exits"][-1][2] == s0["global_games_added"]
    final = [_restore(tmp_path / "logs" / f"rank{r}" / "training_steps_4") for r in (0, 1)]
    assert ckpt_lib.states_equal(final[0], final[1])
    nets = [torch.load(tmp_path / "logs" / f"rank{r}" / "play_net.pt") for r in (0, 1)]
    assert nets[0].keys() == nets[1].keys()
    assert all(torch.equal(nets[0][k], nets[1][k]) for k in nets[0])
    # One checkpoint per generation, restored in this single process.
    ckpts = sorted(n for n in os.listdir(tmp_path / "ckpt") if n.startswith("training_steps_"))
    assert ckpts == ["training_steps_2", "training_steps_4"]
    assert ckpt_lib.states_equal(_restore(tmp_path / "ckpt" / "training_steps_4"), final[0])
    return s0, s1


def test_dp2_trainer_run_through_cli(tmp_path):
    _wait([_launch(_argv(_sets(tmp_path, "parallel.dp=2", "parallel.selfplay_batch_size=8")))])
    s0, s1 = _check_ranks_agree(tmp_path, generations=2)
    assert s0["games_a_step"] == s1["games_a_step"] == 4  # 8 games split over 2 ranks
    # The warm-up generation stops at min_games, counted over both ranks.
    assert s0["exits"][0][1] >= 4
    assert s0["global_games_added"] == s0["local_games"] + s1["local_games"]
    logs = tmp_path / "logs"
    # Per-rank actor CSVs and replay partitions; every game is in one.
    actors = [_rows(logs / f"actor{r}.csv") for r in (0, 1)]
    assert [len(a) for a in actors] == [s0["local_games"], s1["local_games"]]
    assert all(len(a) > 0 for a in actors) and not (logs / "actor.csv").exists()
    for r, summary in enumerate((s0, s1)):
        with np.load(tmp_path / "ckpt" / f"replay_state_p{r}.npz") as replay:
            assert int(replay["num_games_added"]) == summary["local_games"]
    assert not (tmp_path / "ckpt" / "replay_state.npz").exists()
    # training.csv (rank 0 only) counts every rank's games and samples.
    rows = _rows(logs / "training.csv")
    assert [int(r["training_steps"]) for r in rows] == [1, 2, 3, 4]
    assert int(rows[-1]["total_games"]) == s0["global_games_added"]
    assert int(rows[-1]["total_samples"]) == s0["local_samples"] + s1["local_samples"]
    # The evaluator: rank 0 only, one row per checkpoint.
    assert (s0["has_evaluator"], s1["has_evaluator"]) == (True, False)
    assert [int(r["training_steps"]) for r in _rows(logs / "evaluation.csv")] == [2, 4]

    # The dp=2 checkpoint resumes in one process.
    cli_train.main(_argv(_sets(tmp_path, "parallel.selfplay_batch_size=4",
                               "train.max_training_steps=6",
                               f"run.load_ckpt={tmp_path}/ckpt/training_steps_4"), False))
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ckpt")).endswith("training_steps_6")
    assert _restore(tmp_path / "ckpt" / "training_steps_6").training_steps == 6


def test_coordinator_ranks_resume_a_single_process_checkpoint(tmp_path):
    # A single-process run to step 2, then two coordinator ranks on to 4.
    cli_train.main(_argv(_sets(tmp_path, "parallel.selfplay_batch_size=4",
                               "train.max_training_steps=2"), False))
    address = multihost.local_address()
    _wait([_launch(_argv(_sets(
        tmp_path, "parallel.selfplay_batch_size=4", f"parallel.coordinator_address={address}",
        "parallel.num_processes=2", f"parallel.process_id={r}",
        f"run.load_ckpt={tmp_path}/ckpt/training_steps_2"), False)) for r in (0, 1)])
    s0, s1 = _check_ranks_agree(tmp_path, generations=1)
    # A coordinator's rank plays selfplay_batch_size games of its own.
    assert s0["games_a_step"] == s1["games_a_step"] == 4
    assert not s0["has_evaluator"] and not (tmp_path / "logs" / "evaluation.csv").exists()
    assert (tmp_path / "logs" / "actor1.csv").exists()


def test_profile_writes_a_trace_of_selfplay_and_training(tmp_path):
    cfg = resolve_config("gomoku9", _sets(tmp_path, "parallel.selfplay_batch_size=4",
                                          "train.max_training_steps=2"))
    trainer = pipeline.Trainer(cfg, device="cpu")
    trainer.run()
    games = trainer.replay.num_games_added
    path = trainer.profile(num_steps=2)
    assert path == os.path.join(cfg.run.logs_dir, "profile", "trace_rank0.json")
    assert trainer.training_steps == 3 and trainer.replay.num_games_added >= games
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"selfplay", "train_step"} <= names
    # Self-play's and the learner's own ops, forward and backward.
    for op in ("aten::convolution", "aten::scatter_add_", "aten::_softmax",
               "ConvolutionBackward0"):
        assert any(op in n for n in names), op


def test_model_axis_raises_naming_the_roadmap_item(tmp_path):
    # Three coordinator ranks cannot form model groups of 2: cli.train and
    # the Trainer raise before any process group is started.
    sets = _sets(tmp_path, "parallel.mdl=2", "parallel.coordinator_address=localhost:1",
                 "parallel.num_processes=3", "parallel.process_id=0")
    with pytest.raises(ValueError, match="3 ranks not divisible by mdl=2"):
        cli_train.main(_argv(sets, False))
    with pytest.raises(ValueError, match="3 ranks not divisible by mdl=2"):
        pipeline.Trainer(resolve_config("gomoku9", sets), device="cpu")
    # parallel.mdl=2 without its two ranks' process group.
    with pytest.raises(RuntimeError, match="start the ranks with cli.train"):
        pipeline.Trainer(resolve_config("gomoku9", _sets(tmp_path, "parallel.mdl=2")),
                         device="cpu")
