"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``alpha_zero_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, checks the port on the
card against its CPU path on small inputs, then drives the port's paths:

- [5] go9 self-play moves (9x9 Go, 10 blocks x 128 filters in bf16 with
  random weights, 200 simulations, subtree reuse, max_new_sims=120) at
  B=1024 games through ``init_selfplay_state`` and ``make_selfplay_step``:
  every select through the select kernel K1 (120 launches a move), every
  tree write through the tree-row writer K2 (2 a simulation, 240 a move);
  one more move under ``torch.profiler`` counts all its device kernels.
- [6] K2 and K3 bit-equal to their plain versions on the searched go9
  tree's materialize and expand sets, go19-shaped int16 rows and 1-byte
  rows, then the row-scatter probe
  (``alpha_zero_tpu_torch/tools/dma_probe.py:run_probe``, the entry point
  of K3 and the timer of both) at go9 and gomoku13 tree shapes.
- [7] gomoku13 self-play (13x13 Gomoku, 10 x 40 net in bf16, padding-3
  stem, 380 simulations, reuse, max_new_sims=240) at B=1024: 240 K1 and
  480 K2 launches a move, K2 bit-equal on the searched tree's sets (int16
  2-byte rows), the Gomoku engine on the card equal to its CPU path.
- [8] the training path: ``cli.train.main`` in-process at go9 full width
  (bf16 compute, float32 master weights, 1024 self-play games, train batch
  1024; ``env.max_steps=GAME_STEPS`` is the one cut), two generations of 10 steps
  with run and checkpoint directories under ``build/``: launches per
  move as in [5], replay against the harvested games, finite losses, both
  checkpoints restored bit-equal, the bf16 self-play net equal to the
  master weights after each generation (BatchNorm float32, every other
  tensor bf16), a Trainer resumed from ``training_steps_10`` taking the
  original's next step bit for bit; ms per train step, samples/s, seconds
  per generation, peak memory. The evaluator runs after each generation
  (``run.eval_games=2``, pro metrics over ``logs/go/9x9_matched/sgf``):
  one ``evaluation.csv`` row per checkpoint with the JAX package's header,
  Elo columns equal to an ``EloRating`` replay of the recorded games,
  finite pro metrics, 199 K1 and 398 K2 launches in every evaluation ply
  (fresh trees), and its pro-game dataset built on the card bit-equal to
  the CPU's.
- [9] matches: ``cli.match.main`` in-process, ``training_steps_10`` (black)
  against ``training_steps_20`` at go9 full width, 64 games in lockstep
  (``env.max_steps=GAME_STEPS``), then one deterministic ``eval_games=1`` game
  between them: every move legal on a replay through the host ``GoEnv``,
  the results equal to ``log.csv``, 199 K1 and 398 K2 launches a ply, and
  K1 and K2 bit-equal to their plain versions on searched trees at B=1
  and B=2, timed at B=1 and B=64.
- [10] data parallel: ``cli.train.main`` with ``parallel.dp=2`` on the one
  card (two ranks on ``cuda:0`` over gloo, spawned by ``cli.train``; their
  instrument is ``rank_checks``), go9 full width, 512 games and 512
  train rows a rank, ``env.max_steps=24``, one generation of 10 steps,
  ``--no-eval``: 120 K1 and 240 K2 launches in every move of each rank,
  both ranks leaving self-play on the same move with the same global game
  count, the ranks' train states and self-play nets bit-equal, the
  checkpoint restored bit-equal here, the first DP step's losses and weight
  update against one step in this process on both ranks' rows, finite
  losses; seconds of self-play, training and fences, ms per DP train step,
  peak memory per rank. [8] also calls ``Trainer.profile(num_steps=1)``,
  whose trace must name both kernels.
- [11] the model axis: ``cli.train.main`` with ``parallel.dp=1,
  parallel.mdl=2`` (two gloo ranks on ``cuda:0``, one model group, each
  holding half the output channels of the stem, the 20 block convs,
  ``policy_conv``, ``policy_fc`` and ``value_fc1``), go9 full width, 64
  games, ``env.max_steps=5``, train batch 256, 4 steps and one checkpoint,
  ``--no-eval``: 120 K1 and 240 K2 launches and 24 gathers a net
  evaluation in every move of each rank, the replicas' games, trees,
  replay rows and weights bit-equal (digests), each rank's slices equal to
  the gathered net's, the checkpoint (whole layout) restored here into a
  whole bf16 net whose outputs on 256 replay rows are within
  ``MDL_NET_ATOL`` of the sharded net's, the first sharded step against
  one step of this process (losses within ``MDL_LOSS_ATOL``, the update as
  in [10]); seconds a move, host seconds in gathers, ms per sharded train
  step, peak memory a rank.
- [12] the dry run: ``parallel/dryrun.py:dryrun_multichip(4, "cuda")``,
  four gloo ranks on ``cuda:0`` at dp=2 x mdl=2 (one train step, one
  self-play move on 5x5 Go), its OK line, 5 K1 and 10 K2 launches a rank.

The select kernel K1 is held bit-equal to its plain version on go9 trees
of the port's own search, a ragged batch, and synthetic trees at the
gomoku13 and go19_jumbo tree shapes, then timed at go9: ``ms`` is its
device time from a CUDA-graph replay, warm in L2, ``cold_ms`` the same with
L2 flushed before each call, ``back_to_back_ms`` the time of back-to-back
calls with the host's dispatch
(``alpha_zero_tpu_torch/tools/select_bench.py:time_select``). K2 is timed
the same three ways on the go9 materialize set (its ``ms``; the expand set
and the single f32 array beside it), each in turns with the ``put_rows``
sequence it replaced, and with every lane idle (its launch floor). The
kernels' launch counts are set to 0 before each of [5], [7], [8], [9] and
[10], [11] and [12] (in each of their ranks) and read after it;
``launches`` sums them,
``launches_by_path`` splits them (``go9_training`` is [8]'s self-play and
profiled move, ``go9_eval`` its evaluation plies and [9]'s eval game,
``go9_match`` the ``cli.match`` run, ``go9_dp2`` [10]'s two ranks,
``go9_mdl2`` [11]'s and ``dryrun`` [12]'s four, each counted in its own
process and carried back).

Every phase raises on failure; there is no CPU fallback. The line before
the last is the card's name and power limit; the line before that is one
JSON object with each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root (the
package must sit beside this file).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 1024
TIMED_MOVES = 3
GOMOKU_TIMED_MOVES = 2
TRAIN_STEPS = 20
MATCH_GAMES = 64
# [8]'s and [9]'s games end at this many moves. 24 until the model axis
# added [11] and [12]: their evaluations and matches, launch-bound at 2-4 s
# a ply, took 600 s of a 1287 s run on a slower card, past the 1200 s the
# script has.
GAME_STEPS = 12
# [10]'s first DP step (bf16 compute, two ranks of 512 rows) against one
# step of the same net on the 1024 rows in one process: cuDNN picks its
# convolution algorithms per batch size, so bf16 activations may round
# differently (one bf16 ulp, 2^-8 relative), and the BN moments are summed
# across ranks instead of taken over one tensor. Averaged over 1024 rows
# that moves the policy loss (~4.4) and the value loss (~1) by far less
# than 1e-2, which still catches a wrong reduction (local BN moments or an
# unaveraged gradient move them by more).
DP_LOSS_ATOL = 1e-2
# The same step's weight update (every parameter) is held to the float32
# step's on the 1024 rows: its distance from it (L2, relative to the
# float32 update) at most DP_UPDATE_FACTOR times the single-process bf16
# step's. bf16 gradients through Flax's ill-conditioned BatchNorm variance
# are far from float32 ones (tests/test_torch_learner.py: 17-41% per tensor
# after three steps), and two ranks round differently from one process, so
# no fixed bound on DP vs single bf16 holds; a summed gradient left
# undivided, or one rank's gradient alone, lands ~100% or tens of percent
# off the float32 update, well past twice the bf16 step's own error.
DP_UPDATE_FACTOR = 2.0
# [11]: one model group of two ranks (go9, 64 games, train batch 256). Its
# first sharded step is held to one in-process step on the same 256 rows
# (DP_UPDATE_FACTOR for the update): the ranks hold the same rows and the
# same BatchNorm moments, and only cuDNN's choice of kernel for a layer of
# 64 output channels instead of 128 may round the bf16 activations
# differently, which moves a loss averaged over 256 rows by far less than
# 1e-3; a missing gradient sum over the model group moves it by more.
MDL_BATCH = 64
MDL_TRAIN_BATCH = 256
MDL_LOSS_ATOL = 1e-3
# The checkpoint restored into a whole bf16 net against the sharded bf16
# self-play net on the first 256 replay rows: the same weights and
# arithmetic, but a kernel picked per shape may round differently at each
# of 21 convolutions. The bf16 port stands 0.094 (logits) and 0.040 (value)
# off Flax's bf16 net on a trained go9 checkpoint (ROADMAP C1), two
# implementations apart; 0.1 bounds a rounding difference and is far below
# a wrong gather (channels out of order or one rank's slice twice), which
# moves logits by O(1).
MDL_NET_ROWS = 256
MDL_NET_ATOL = 0.1
EVAL_HEADER = ["datetime", "training_steps", "game_length", "game_result", "num_passes",
               "black_elo_rating", "white_elo_rating", "eval_games", "latest_win_rate",
               "value_mse_error", "policy_entropy", "policy_top_1_accuracy",
               "policy_top_3_accuracy", "policy_top_5_accuracy"]


def play_moves(label, cfg, engine, net, moves, dev, profiled=False):
    """Self-play ``moves`` moves of ``BATCH`` games of ``cfg`` through
    ``init_selfplay_state``/``make_selfplay_step``, each checked: exactly
    ``max_new_sims`` K1 and twice as many K2 launches, every move legal and
    on an empty point, ``search_pi`` rows summing to 1, ``root_visits`` within
    the budget, finite values. With ``profiled``, one more move runs under
    ``torch.profiler``. Returns the env-steps/s of the timed moves (all but
    the first, a warm-up, and the profiled one), the self-play state after
    the last move and the profiled move's device kernel launches (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.training import selfplay

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    step = selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = selfplay.init_selfplay_state(
        engine, BATCH, gen, resign_threshold=-1.0,
        disable_resign_ratio=cfg.resign.disable_resign_ratio,
        reuse_num_simulations=cfg.search.num_simulations, device=dev)
    loop_len = cfg.search.max_new_sims
    torch.cuda.synchronize()
    elapsed = 0.0
    kernels = None
    for move_idx in range(moves + int(profiled)):
        before, writes_before = select.launches, writer.launches
        legal, board = sp.games.legal, sp.games.board.flatten(1)
        t0 = time.time()
        if move_idx == moves:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sp, out = step(sp, gen, -1.0)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
        else:
            sp, out = step(sp, gen, -1.0)
            torch.cuda.synchronize()
        if 0 < move_idx < moves:
            elapsed += time.time() - t0
        where = f"{label} move {move_idx}"
        if select.launches - before != loop_len:
            raise SystemExit(f"{where}: {select.launches - before} select launches, "
                             f"expected {loop_len}")
        if writer.launches - writes_before != 2 * loop_len:
            raise SystemExit(f"{where}: {writer.launches - writes_before} tree-row "
                             f"writer launches, expected {2 * loop_len}")
        move = out.move.long()
        if not ((move >= 0) & (move < engine.num_actions)).all():
            raise SystemExit(f"{where}: move out of range")
        if not (legal.gather(1, move[:, None]) == 1.0).all():
            raise SystemExit(f"{where}: illegal move")
        on_board = move < board.shape[1]  # not a pass
        stones = board.gather(1, move.clamp(max=board.shape[1] - 1)[:, None])[:, 0]
        if not (stones[on_board] == 0).all():
            raise SystemExit(f"{where}: a move on an occupied point")
        if not torch.allclose(out.search_pi.sum(-1), torch.ones(BATCH, device=dev),
                              atol=1e-5):
            raise SystemExit(f"{where}: search_pi rows do not sum to 1")
        if not (out.root_visits <= cfg.search.num_simulations).all():
            raise SystemExit(f"{where}: root_visits above the budget")
        if not all(torch.isfinite(x).all() for x in (out.root_q, out.best_child_q)):
            raise SystemExit(f"{where}: non-finite values")
    return BATCH * (moves - 1) / elapsed, sp, kernels


def check_engine_on_card(label, engine, games, dev):
    """``games`` random games through the engine on the card and on the
    CPU, to their end; every field equal after every step."""
    import torch

    rng = torch.Generator().manual_seed(3)
    s_cpu = engine.init_batch(games, device="cpu")
    s_gpu = engine.init_batch(games, device=dev)
    for i in range(engine.max_steps + 1):
        weights = s_cpu.legal + s_cpu.done[:, None].float()  # any move once done
        moves = torch.multinomial(weights, 1, generator=rng)[:, 0].to(torch.int32)
        s_cpu = engine.step_batch(s_cpu, moves)
        s_gpu = engine.step_batch(s_gpu, moves.to(dev))
        on_card = s_gpu.to_numpy()
        for key, val in s_cpu.to_numpy().items():
            if not (on_card[key] == val).all():
                raise SystemExit(f"{label} engine on the card != CPU at move {i}: {key}")
        if bool(s_cpu.done.all()):
            break
    if not bool(s_cpu.done.all()):
        raise SystemExit(f"{label} engine: games did not end")
    print(f"{label} engine on the card == CPU: {games} random games to their end "
          f"({i + 1} moves), every field", flush=True)


def counting(fn, plies):
    """``fn`` wrapped to append each call's (K1 launches, K2 launches,
    seconds) to ``plies``."""
    import torch

    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows

    def counted(*args, **kwargs):
        s0, w0 = select.launches, writer.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        plies.append((select.launches - s0, writer.launches - w0, time.perf_counter() - t0))
        return out
    return counted


def check_plies(label, plies, sims):
    """Every ply a fresh-tree search: ``sims - 1`` K1 launches and twice as
    many K2 launches."""
    counts = sorted({(k1, k2) for k1, k2, _ in plies})
    if not plies or counts != [(sims - 1, 2 * (sims - 1))]:
        raise SystemExit(f"{label}: launches per ply {counts}, expected "
                         f"({sims - 1}, {2 * (sims - 1)})")


def train_path(card, dev) -> dict:
    """[8]: ``cli.train.main`` in-process at go9 full width (10 x 128, bf16
    compute, float32 master weights, 1024 self-play games, train batch
    1024), cut only in game length (``env.max_steps=GAME_STEPS``), two generations
    of 10 steps. Checks the launches of every self-play move, the replay
    against the harvested games, finite losses, both checkpoints restored
    bit-equal, the self-play net after each generation, and a resumed
    Trainer's next step bit-equal to the original's; times the train step.
    The evaluator runs after each generation and is checked (see the module
    docstring). Leaves the checkpoints for [9]."""
    import copy
    import csv
    import math

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from alpha_zero_tpu_torch.cli import train as cli_train
    from alpha_zero_tpu_torch.cli.common import resolve_config
    from alpha_zero_tpu_torch.eval import evaluator as evaluator_lib
    from alpha_zero_tpu_torch.eval import match as match_lib
    from alpha_zero_tpu_torch.eval.dataset import build_eval_dataset
    from alpha_zero_tpu_torch.eval.elo import EloRating
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
    from alpha_zero_tpu_torch.training import learner, pipeline, selfplay
    from alpha_zero_tpu_torch.utils import sgf as sgf_lib
    from alpha_zero_tpu_torch.utils.device import BF16_OPS_PER_S

    run_dir = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt_dir, logs_dir = os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "logs")
    sgf_dir = os.path.join(run_dir, "sgf")
    games_dir = os.path.join(HERE, "logs", "go", "9x9_matched", "sgf")
    sets = [f"parallel.selfplay_batch_size={BATCH}", f"train.batch_size={BATCH}",
            f"env.max_steps={GAME_STEPS}", f"train.min_games={BATCH}",
            f"train.games_per_ckpt={BATCH}", "train.ckpt_interval=10",
            f"train.max_training_steps={TRAIN_STEPS}",
            f"run.ckpt_dir={ckpt_dir}", f"run.logs_dir={logs_dir}", "run.eval_games=2",
            f"run.eval_games_dir={games_dir}", f"run.save_sgf_dir={sgf_dir}",
            "run.save_sgf_interval=0"]
    argv = ["--config", "go9", "--device", str(dev)] + [
        x for v in sets for x in ("--set", v)]
    cfg = resolve_config("go9", sets)

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    seen = {"moves": [], "selfplay_s": [], "generation_s": [], "checkpoint_s": [],
            "eval_s": [], "eval_plies": [], "snapshots": {}, "trainer": None}
    make_step, selfplay_until = selfplay.make_selfplay_step, pipeline.Trainer.selfplay_until
    train_generation, save = pipeline.Trainer.train_generation, ckpt_lib.save_checkpoint
    make_match, evaluate = match_lib.make_match_move_fn, evaluator_lib.Evaluator.evaluate

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def counting_make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(*a, **k):
            s0, w0 = select.launches, writer.launches
            out = step(*a, **k)
            seen["moves"].append((select.launches - s0, writer.launches - w0))
            return out
        return counted

    def generation(self):
        timed(train_generation, "generation_s")(self)
        master = self.train_state.net.state_dict()
        bn = {n for n, m in self.play_net.named_modules()
              if isinstance(m, torch.nn.BatchNorm2d)}
        for name, value in self.play_net.state_dict().items():
            want = (torch.float32 if name.rsplit(".", 1)[0] in bn else torch.bfloat16)
            if value.is_floating_point() and value.dtype != want:
                raise SystemExit(f"[8] self-play net's {name} is {value.dtype}, not {want}")
            if not torch.equal(value, master[name].to(value.dtype)):
                raise SystemExit(f"[8] self-play net != master weights cast to "
                                 f"{value.dtype} after step {self.training_steps}: {name}")
        seen["snapshots"][self.training_steps] = copy.deepcopy(self.train_state)
        seen["trainer"] = self

    torch.cuda.reset_peak_memory_stats()
    selfplay.make_selfplay_step = counting_make
    pipeline.Trainer.selfplay_until = timed(selfplay_until, "selfplay_s")
    pipeline.Trainer.train_generation = generation
    ckpt_lib.save_checkpoint = timed(save, "checkpoint_s")
    match_lib.make_match_move_fn = lambda *a, **k: counting(make_match(*a, **k),
                                                            seen["eval_plies"])
    evaluator_lib.Evaluator.evaluate = timed(evaluate, "eval_s")
    t0 = time.time()
    try:
        cli_train.main(argv)
    finally:
        selfplay.make_selfplay_step = make_step
        pipeline.Trainer.selfplay_until = selfplay_until
        pipeline.Trainer.train_generation = train_generation
        ckpt_lib.save_checkpoint = save
        match_lib.make_match_move_fn = make_match
        evaluator_lib.Evaluator.evaluate = evaluate
    wall = time.time() - t0
    trainer = seen["trainer"]
    loop_len = cfg.search.max_new_sims
    if trainer is None or trainer.training_steps != TRAIN_STEPS:
        raise SystemExit("[8] the run did not reach its step budget")
    if not seen["moves"] or set(seen["moves"]) != {(loop_len, 2 * loop_len)}:
        raise SystemExit(f"[8] launches per self-play move {sorted(set(seen['moves']))}, "
                         f"expected ({loop_len}, {2 * loop_len})")

    # The evaluator: a row per checkpoint, Elo, pro metrics, launches.
    check_plies("[8] evaluation", seen["eval_plies"], cfg.search.num_simulations)
    with open(os.path.join(logs_dir, "evaluation.csv")) as f:
        header = next(csv.reader(f))
        f.seek(0)
        eval_rows = list(csv.DictReader(f))
    if header != EVAL_HEADER:
        raise SystemExit(f"[8] evaluation.csv header {header}")
    if [int(r["training_steps"]) for r in eval_rows] != [10, TRAIN_STEPS]:
        raise SystemExit(f"[8] evaluation.csv rows for steps "
                         f"{[r['training_steps'] for r in eval_rows]}, expected 10 and 20")
    # Elo replay: game 0 (the latest net black) from its SGF, the other
    # game (the latest net white) from the row's win counts.
    black_elo, white_elo = EloRating(0.0), EloRating(0.0)
    for row in eval_rows:
        with open(os.path.join(sgf_dir, f"eval_training_steps_{row['training_steps']}.sgf")) as f:
            first = sgf_lib.parse_game_result(sgf_lib.parse_sgf(f.read()).result)
        wins = [int(x) for x in row["game_result"].split()[1].split("-")] + [0]
        latest, prev = wins[0] - (first == 1), wins[1] - (first == -1)
        for latest_won in [first == 1] * (first != 0) + [True] * latest + [False] * prev:
            a, b = (black_elo, white_elo) if latest_won else (white_elo, black_elo)
            a.update_rating(b.rating, 1)
            b.update_rating(a.rating, 0)
        if (float(row["black_elo_rating"]), float(row["white_elo_rating"])) != (
                black_elo.rating, white_elo.rating):
            raise SystemExit(f"[8] Elo columns {row['black_elo_rating']}, "
                             f"{row['white_elo_rating']} != replay {black_elo.rating}, "
                             f"{white_elo.rating}")
        white_elo = EloRating(black_elo.rating)
        pro = {k: float(row[k]) for k in EVAL_HEADER[9:]}
        if not (all(math.isfinite(v) and v >= 0 for v in pro.values())
                and all(pro[k] <= 1 for k in EVAL_HEADER[11:])):
            raise SystemExit(f"[8] pro metrics out of range: {pro}")
    dataset = trainer.evaluator.dataset
    on_cpu = build_eval_dataset(games_dir, 9, cfg.env.num_stack, device="cpu")
    if not (np.array_equal(dataset.states, on_cpu.states)
            and np.array_equal(dataset.target_pi, on_cpu.target_pi)
            and np.array_equal(dataset.target_v, on_cpu.target_v)
            and dataset.num_games == on_cpu.num_games
            and dataset.mismatch_stats == on_cpu.mismatch_stats):
        raise SystemExit("[8] the eval dataset built on the card != the CPU's")

    # Replay against the harvested games; its contents.
    replay = trainer.replay
    with open(os.path.join(logs_dir, "actor0.csv")) as f:
        games = list(csv.DictReader(f))
    harvested = sum(int(g["game_length"]) for g in games)
    if not replay.size == replay.num_samples_added == harvested > 0:
        raise SystemExit(f"[8] replay holds {replay.size} samples, {harvested} harvested")
    if replay.num_games_added != len(games):
        raise SystemExit(f"[8] replay {replay.num_games_added} games, CSV {len(games)}")
    n = replay.size
    obs, pis, values = replay.states[:n], replay.pi_probs[:n], replay.values[:n]
    if obs.dtype != np.int8 or not np.isin(obs, (0, 1)).all():
        raise SystemExit("[8] replay observations are not int8 0/1 planes")
    if not np.allclose(pis.sum(-1), 1.0, atol=1e-5):
        raise SystemExit("[8] replay pi rows do not sum to 1")
    if not np.isin(values, (-1.0, 0.0, 1.0)).all():
        raise SystemExit("[8] replay values outside {-1, 0, 1}")
    with open(os.path.join(logs_dir, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [(float(r["policy_loss"]), float(r["value_loss"])) for r in rows]
    if not losses or not all(math.isfinite(x) for pair in losses for x in pair):
        raise SystemExit(f"[8] losses not finite: {losses}")

    # Both checkpoints, restored into fresh states, bit-equal to the run's.
    def fresh_state():
        net = build_network(cfg.env, cfg.network, device=dev, dtype="float32")
        return learner.create_train_state(net, cfg.train)

    for step_count in (10, TRAIN_STEPS):
        path = os.path.join(ckpt_dir, f"training_steps_{step_count}")
        restored = ckpt_lib.restore_checkpoint(path, fresh_state())
        if not ckpt_lib.states_equal(restored, seen["snapshots"][step_count]):
            raise SystemExit(f"[8] {path} restores a different state")
    if not ckpt_lib.states_equal(trainer.train_state, seen["snapshots"][TRAIN_STEPS]):
        raise SystemExit("[8] the last checkpoint is not the Trainer's state")

    # ms per train step at batch 1024 (CUDA events, after warm-up).
    step = learner.make_train_step(cfg.network.inference_dtype, cfg.train.argument_data)
    batch = replay.sample(BATCH)
    inputs = tuple(torch.from_numpy(x).to(dev) for x in (batch.state, batch.pi_prob,
                                                        batch.value))
    timing_state = copy.deepcopy(trainer.train_state)
    for tid in range(3):
        step(timing_state, *inputs, tid)
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        step(timing_state, *inputs, i % 6)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / reps
    # The step's least time: its convolution and matmul operations
    # (forward and backward, as FlopCounterMode counts them) at the bf16
    # tensor-core peak.
    with FlopCounterMode(display=False) as flops:
        step(timing_state, *inputs, 3)
    step_flops = flops.get_total_flops()
    bound_ms = step_flops / BF16_OPS_PER_S * 1e3
    del timing_state

    # A Trainer resumed from training_steps_10 takes the same next step as
    # the original (cuDNN deterministic: bit-equal).
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ckpt10 = os.path.join(ckpt_dir, "training_steps_10")
        resumed = pipeline.Trainer(resolve_config("go9", sets + [f"run.load_ckpt={ckpt10}"]),
                                   device=dev)
        original = seen["snapshots"][10]
        if not ckpt_lib.states_equal(resumed.train_state, original):
            raise SystemExit("[8] the resumed Trainer's state != the original's at step 10")
        m_orig = step(original, *inputs, 3)
        m_res = step(resumed.train_state, *inputs, 3)
        if not (ckpt_lib.states_equal(resumed.train_state, original)
                and torch.equal(m_orig.policy_loss, m_res.policy_loss)
                and torch.equal(m_orig.value_loss, m_res.value_loss)):
            raise SystemExit("[8] the resumed Trainer's next step != the original's")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    peak = torch.cuda.max_memory_allocated() / 2**30

    # Trainer.profile: one self-play move and one train step under
    # torch.profiler; the Chrome trace must name both kernels.
    t0 = time.time()
    trace = trainer.profile(num_steps=1)
    with open(trace, "rb") as f:
        trace_bytes = f.read()
    missing = [k for k in (b"select_leaf_kernel", b"write_rows_kernel") if k not in trace_bytes]
    if missing:
        raise SystemExit(f"[8] the profile trace {trace} names no {missing}")
    profile_s = time.time() - t0
    os.remove(trace)

    gens = [{"selfplay_s": sp_s, "train_s": gen_s - ck_s, "checkpoint_s": ck_s}
            for sp_s, gen_s, ck_s in zip(seen["selfplay_s"], seen["generation_s"],
                                         seen["checkpoint_s"])]
    out = {"config": "go9", "reduced": {"env.max_steps": GAME_STEPS}, "selfplay_batch": BATCH,
           "train_batch": BATCH, "training_steps": TRAIN_STEPS,
           "selfplay_moves": len(seen["moves"]), "games": len(games), "samples": n,
           "train_step_ms": step_ms, "train_samples_per_s": BATCH * 1e3 / step_ms,
           "train_step_flops": step_flops, "train_step_bound_ms": bound_ms,
           "generations": gens, "wall_s": wall, "peak_memory_gib": peak,
           "profile_s": profile_s, "profile_trace_mb": len(trace_bytes) / 1e6,
           "losses": losses, "eval_s": seen["eval_s"],
           "eval_plies": len(seen["eval_plies"]),
           "eval_ply_s": sum(t for _, _, t in seen["eval_plies"]) / len(seen["eval_plies"]),
           "eval_launches": [sum(x[i] for x in seen["eval_plies"]) for i in (0, 1)],
           "eval_dataset_positions": len(dataset), "evaluation_rows": eval_rows}
    print(f"[8] go9 training via cli.train (10 x 128, bf16 compute, f32 master weights; "
          f"{BATCH} self-play games, train batch {BATCH}; env.max_steps={GAME_STEPS} the only "
          "cut) "
          f"on {card}: {len(seen['moves'])} self-play moves ({loop_len} K1 and "
          f"{2 * loop_len} K2 launches each), {len(games)} games, {n} samples, "
          f"{TRAIN_STEPS} train steps; {step_ms:.3f} ms per train step at batch {BATCH} "
          f"({BATCH * 1e3 / step_ms:.0f} samples/s; bound {bound_ms:.3f} ms: "
          f"{step_flops / 1e12:.3f} TFLOP at the bf16 peak); generations (self-play / train / "
          f"checkpoint s): "
          + "; ".join(f"{g['selfplay_s']:.2f} / {g['train_s']:.3f} / {g['checkpoint_s']:.3f}"
                      for g in gens)
          + f"; {wall:.1f} s in cli.train; peak memory {peak:.2f} GiB", flush=True)
    print(f"[8] checkpoints training_steps_10/20 restored bit-equal; self-play net == "
          f"master weights (bf16, BatchNorm float32) after each generation; resumed "
          f"Trainer's next step bit-equal; losses {losses}; Trainer.profile(num_steps=1) "
          f"wrote a {len(trace_bytes) / 1e6:.1f} MB Chrome trace naming select_leaf_kernel "
          f"and write_rows_kernel in {profile_s:.1f} s", flush=True)
    print(f"[8] evaluator on {card}: {len(eval_rows)} evaluation.csv rows, Elo replayed "
          f"equal, pro metrics over {len(dataset)} positions (dataset on the card == CPU); "
          f"{out['eval_plies']} evaluation plies of {cfg.search.num_simulations - 1} K1 and "
          f"{2 * (cfg.search.num_simulations - 1)} K2 launches; "
          + ", ".join(f"{x:.2f}" for x in seen["eval_s"]) + " s per evaluation, "
          f"{out['eval_ply_s']:.3f} s per ply (B=1)", flush=True)
    print("[8] " + json.dumps(out), flush=True)
    return out, ckpt_dir


def rank_checks(trainer) -> None:
    """[10]'s and [11]'s instrument in each rank (``cli.train``'s ``prepare``
    hook, so it runs in the spawned process): K1/K2 launches, net forward
    passes and model-axis gathers of every self-play move (the counts set
    to 0 just before the run), each exit from self-play, seconds of
    self-play, of the fences, of the gathers and of each train generation,
    the first step's local batch and global losses, then, after the run, ms
    per train step (CUDA events, on a copy of the state), peak memory, the
    final train state and self-play net in the whole layout, digests of the
    rank's games, trees, replay rows and weights, this rank's slices
    against the gathered net and its bf16 self-play net's outputs on the
    first ``MDL_NET_ROWS`` replay rows. Writes them under
    ``logs_dir/rank{r}``; raises if a move's launches or gathers are off or
    a slice differs from the gathered net."""
    import copy

    import numpy as np
    import torch

    from alpha_zero_tpu_torch.models.resnet import gather_state_dict, shard_state_dict
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.ops.symmetry import random_transform_id
    from alpha_zero_tpu_torch.parallel import multihost
    from alpha_zero_tpu_torch.parallel.dryrun import digest
    from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
    from alpha_zero_tpu_torch.utils.device import time_ms

    # The parent's float32 settings, for the parity step it computes.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    gathers = multihost.all_gather_channels
    out_dir = os.path.join(trainer.cfg.run.logs_dir, f"rank{trainer.rank}")
    os.makedirs(out_dir, exist_ok=True)
    rec = {"rank": trainer.rank, "world": trainer.world, "device": str(trainer.device),
           "mesh": list(trainer.mesh), "dp_index": trainer.dp_index,
           "games_a_step": int(trainer.sp_state.games.done.shape[0]),
           "local_batch": trainer.local_batch_size, "moves": [], "exits": [],
           "selfplay_s": [], "generation_s": [], "fence_s": 0.0, "fences": 0,
           "gather_s": 0.0, "sharded_layers": len(trainer.play_net.sharded_names())}
    ckpt_lib.save_checkpoint(os.path.join(out_dir, "init"), trainer.train_state, 0,
                             write=trainer.is_host0)
    step_fn, until, fence = trainer.selfplay_step, trainer.selfplay_until, trainer._fence
    train_step, generation, run = trainer.train_step, trainer.train_generation, trainer.run
    gather_slices = multihost.gather_slices
    forwards = [0]
    trainer.play_net.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    def timed_gather(*args, **kwargs):
        t0 = time.perf_counter()
        out = gather_slices(*args, **kwargs)
        rec["gather_s"] += time.perf_counter() - t0
        return out

    def counted_step(*args, **kwargs):
        s0, w0, f0, g0 = select.launches, writer.launches, forwards[0], gathers.calls
        out = step_fn(*args, **kwargs)
        rec["moves"].append((select.launches - s0, writer.launches - w0, forwards[0] - f0,
                             gathers.calls - g0))
        return out

    def timed_until(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = until(*args, **kwargs)
        torch.cuda.synchronize()
        rec["selfplay_s"].append(time.perf_counter() - t0)
        rec["exits"].append([len(rec["moves"]), n, trainer.global_games_added])
        return n

    def timed_fence(pending):
        t0 = time.perf_counter()
        out = fence(pending)
        rec["fence_s"] += time.perf_counter() - t0
        rec["fences"] += 1
        return out

    def first_step_saved(state, states, pis, values, tid):
        metrics = train_step(state, states, pis, values, tid)
        if "first_step" not in rec:
            np.savez(os.path.join(out_dir, "first_step.npz"), states=states.cpu().numpy(),
                     pis=pis.cpu().numpy(), values=values.cpu().numpy(), tid=tid)
            rec["first_step"] = [float(metrics.policy_loss), float(metrics.value_loss)]
            ckpt_lib.save_checkpoint(os.path.join(out_dir, "step1"), state, 1)
        return metrics

    def timed_generation():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation()
        torch.cuda.synchronize()
        rec["generation_s"].append(time.perf_counter() - t0)

    def checked_run(*args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        select.launches = writer.launches = gathers.calls = 0
        multihost.gather_slices = timed_gather
        t0 = time.perf_counter()
        run(*args, **kwargs)
        rec["run_s"] = time.perf_counter() - t0
        multihost.gather_slices = gather_slices
        rec["launches"] = (select.launches, writer.launches)
        rec["gathers"] = gathers.calls
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        loop_len = trainer.cfg.search.max_new_sims
        want = {(loop_len, 2 * loop_len, f, f * rec["sharded_layers"])
                for _, _, f, _ in rec["moves"] if f > 0}
        if not rec["moves"] or set(rec["moves"]) != want:
            raise SystemExit(f"rank {trainer.rank}: (K1, K2, forwards, gathers) per self-play "
                             f"move {sorted(set(rec['moves']))}, expected {sorted(want)} "
                             f"({rec['sharded_layers']} gathers a forward)")
        path = ckpt_lib.save_checkpoint(out_dir, trainer.train_state, trainer.training_steps)
        play_net = gather_state_dict(trainer.play_net)
        torch.save(play_net, os.path.join(out_dir, "play_net.pt"))
        # This rank's slices are the gathered net's, master and self-play.
        for net, whole in ((trainer.train_state.net, gather_state_dict(trainer.train_state.net)),
                           (trainer.play_net, play_net)):
            mine = shard_state_dict(whole, trainer.mesh, trainer.mdl_index)
            if not all(torch.equal(v, mine[k]) for k, v in net.state_dict().items()):
                raise SystemExit(f"rank {trainer.rank}: its slices differ from the gathered net")
        replay = trainer.replay
        rows = replay.states[:MDL_NET_ROWS]
        with torch.no_grad():
            o = trainer.play_net(torch.from_numpy(rows).to(trainer.device))
        torch.save({"rows": torch.from_numpy(rows), "pi_logits": o.pi_logits.cpu(),
                    "value": o.value.cpu()}, os.path.join(out_dir, "net_outputs.pt"))
        rec["digests"] = {
            "games": digest(trainer.sp_state.games), "trees": digest(trainer.sp_state.trees),
            "replay": digest(replay.states[:replay.size], replay.pi_probs[:replay.size],
                             replay.values[:replay.size]),
            "weights": digest(torch.load(path, weights_only=True)["net"], play_net),
            "net_outputs": digest(o.pi_logits, o.value)}
        # ms per train step: every rank steps together on its rows.
        batch = trainer.replay.sample(trainer.local_batch_size)
        inputs = tuple(torch.from_numpy(x).to(trainer.device)
                       for x in (batch.state, batch.pi_prob, batch.value))
        timing_state = copy.deepcopy(trainer.train_state)
        tid = random_transform_id(torch.Generator().manual_seed(0))
        rec["train_step_ms"] = time_ms(lambda: train_step(timing_state, *inputs, tid), 10,
                                       trainer.device)
        with open(out_dir + ".json", "w") as f:
            json.dump(rec, f)

    trainer.selfplay_step, trainer.selfplay_until, trainer._fence = (
        counted_step, timed_until, timed_fence)
    trainer.train_step, trainer.train_generation, trainer.run = (
        first_step_saved, timed_generation, checked_run)


def parallel_run(label, dev, sets, steps, games, loss_atol):
    """``cli.train.main`` on go9 with ``sets`` (the layout, batches and run
    directories under ``build/``), ``--no-eval``, every rank instrumented by
    ``rank_checks``; ``steps`` training steps in one generation of
    ``games`` games. Checks across the ranks: the same exits from self-play
    with at least ``games`` games, bit-equal train states and self-play nets
    (whole layout), ``training_steps_{steps}`` restored bit-equal here, the
    first step's losses within ``loss_atol`` of one step of this process on
    the same rows and its weight update within ``DP_UPDATE_FACTOR`` times
    the single-process bf16 step's distance from the float32 step, finite
    losses. Returns the config, the ranks' records, the wall seconds, the
    numbers of the first-step check and the restored final state."""
    import csv
    import math

    import numpy as np
    import torch

    from alpha_zero_tpu_torch.cli import train as cli_train
    from alpha_zero_tpu_torch.cli.common import resolve_config
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
    from alpha_zero_tpu_torch.training import learner

    cfg = resolve_config("go9", sets)
    logs_dir, ckpt_dir = cfg.run.logs_dir, cfg.run.ckpt_dir
    torch.cuda.empty_cache()
    t0 = time.time()
    cli_train.main(["--config", "go9", "--device", str(dev), "--no-eval"]
                   + [x for v in sets for x in ("--set", v)], prepare=rank_checks)
    wall = time.time() - t0
    world = cfg.parallel.dp * cfg.parallel.mdl
    ranks = []
    for r in range(world):
        with open(os.path.join(logs_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    if any(x["exits"] != r0["exits"] for x in ranks) or r0["exits"][0][1] < games:
        raise SystemExit(f"{label} exits from self-play differ or fall short: "
                         f"{[x['exits'] for x in ranks]}")

    def fresh_state():
        net = build_network(cfg.env, cfg.network, device=dev, dtype="float32")
        return learner.create_train_state(net, cfg.train)

    final = [ckpt_lib.restore_checkpoint(
        os.path.join(logs_dir, f"rank{r}", f"training_steps_{steps}"), fresh_state())
        for r in range(world)]
    if not all(ckpt_lib.states_equal(final[0], x) for x in final):
        raise SystemExit(f"{label} the ranks' train states differ after training")
    nets = [torch.load(os.path.join(logs_dir, f"rank{r}", "play_net.pt"), map_location=dev)
            for r in range(world)]
    if not all(n.keys() == nets[0].keys() and all(torch.equal(nets[0][k], n[k]) for k in n)
               for n in nets):
        raise SystemExit(f"{label} the ranks' bf16 self-play nets differ")
    restored = ckpt_lib.restore_checkpoint(
        os.path.join(ckpt_dir, f"training_steps_{steps}"), fresh_state())
    if not ckpt_lib.states_equal(restored, final[0]):
        raise SystemExit(f"{label} training_steps_{steps} restores a state other than the "
                         "ranks'")

    # The first step against one step in this process on every model
    # group's rows (a group's replicas hold the same rows).
    groups = range(0, world, cfg.parallel.mdl)
    batches = [np.load(os.path.join(logs_dir, f"rank{r}", "first_step.npz")) for r in groups]
    if (len({int(b["tid"]) for b in batches}) != 1
            or any(x["first_step"] != r0["first_step"] for x in ranks)):
        raise SystemExit(f"{label} the ranks' first steps differ in transform or losses")
    inputs = tuple(torch.from_numpy(np.concatenate([b[k] for b in batches])).to(dev)
                   for k in ("states", "pis", "values"))

    def params(state):
        return torch.cat([p.detach().flatten().clone() for p in state.net.parameters()])

    def init_state():
        return ckpt_lib.restore_checkpoint(
            os.path.join(logs_dir, "rank0", "init", "training_steps_0"), fresh_state())

    def one_process_step(dtype):
        state = init_state()
        m = learner.make_train_step(dtype, cfg.train.argument_data)(
            state, *inputs, int(batches[0]["tid"]))
        return params(state), [float(m.policy_loss), float(m.value_loss)]

    p_bf16, single = one_process_step(cfg.network.inference_dtype)
    p_f32, _ = one_process_step("float32")
    p0 = params(init_state())
    p_par = params(ckpt_lib.restore_checkpoint(
        os.path.join(logs_dir, "rank0", "step1", "training_steps_1"), fresh_state()))
    loss_err = max(abs(a - b) for a, b in zip(single, r0["first_step"]))
    f32_norm = (p_f32 - p0).norm()
    update_err = {"ranks_vs_f32": float((p_par - p_f32).norm() / f32_norm),
                  "bf16_vs_f32": float((p_bf16 - p_f32).norm() / f32_norm),
                  "ranks_vs_bf16": float((p_par - p_bf16).norm() / (p_bf16 - p0).norm())}
    if (loss_err > loss_atol
            or update_err["ranks_vs_f32"] > DP_UPDATE_FACTOR * update_err["bf16_vs_f32"]):
        raise SystemExit(f"{label} first step vs one process on the same rows: losses "
                         f"{r0['first_step']} vs {single} (err {loss_err}, limit "
                         f"{loss_atol}); weight update's relative errors {update_err} "
                         f"(ranks vs float32 at most {DP_UPDATE_FACTOR} x bf16 vs float32)")
    with open(os.path.join(logs_dir, "training.csv")) as f:
        losses = [(float(r["policy_loss"]), float(r["value_loss"])) for r in csv.DictReader(f)]
    if not losses or not all(math.isfinite(x) for pair in losses for x in pair):
        raise SystemExit(f"{label} losses not finite: {losses}")
    check = {"first_step_losses": r0["first_step"], "single_process_losses": single,
             "loss_err": loss_err, "update_rel_err": update_err, "losses": losses}
    return cfg, ranks, wall, check, restored


def dp_path(card, dev) -> dict:
    """[10]: ``cli.train.main`` with ``parallel.dp=2`` on the one card: two
    gloo ranks on ``cuda:0`` at go9 full width (bf16, 200 sims, reuse,
    ``max_new_sims=120``; ``selfplay_batch_size=1024``, 512 games a rank;
    ``train.batch_size=1024``, 512 rows a rank), ``env.max_steps=24``, one
    generation of 10 steps, ``--no-eval``, checked by ``parallel_run``
    (the first step's losses within ``DP_LOSS_ATOL``). Returns the numbers
    and each rank's (K1, K2) launches."""
    run_dir = os.path.join(HERE, "build", "chip_smoke_dp")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt_dir, logs_dir = os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "logs")
    sets = ["parallel.dp=2", f"parallel.selfplay_batch_size={BATCH}",
            f"train.batch_size={BATCH}", "env.max_steps=24", f"train.min_games={BATCH}",
            f"train.games_per_ckpt={BATCH}", "train.ckpt_interval=10",
            "train.max_training_steps=10", f"run.ckpt_dir={ckpt_dir}",
            f"run.logs_dir={logs_dir}"]
    cfg, ranks, wall, check, _ = parallel_run("[10]", dev, sets, 10, BATCH, DP_LOSS_ATOL)
    r0 = ranks[0]
    if [x["games_a_step"] for x in ranks] != [BATCH // 2] * 2 or r0["world"] != 2:
        raise SystemExit(f"[10] games a rank {[x['games_a_step'] for x in ranks]}")
    out = {"config": "go9", "reduced": {"env.max_steps": 24, "training_steps": 10},
           "ranks": 2, "backend": "gloo", "selfplay_batch": BATCH, "train_batch": BATCH,
           "selfplay_moves": len(r0["moves"]), "exits": r0["exits"],
           "selfplay_s": [x["selfplay_s"] for x in ranks],
           "train_s": [x["generation_s"] for x in ranks],
           "fence_s": [x["fence_s"] for x in ranks], "fences": r0["fences"],
           "train_step_ms": [x["train_step_ms"] for x in ranks],
           "peak_memory_gib": [x["peak_memory_gib"] for x in ranks],
           "launches": [x["launches"] for x in ranks], **check, "wall_s": wall}
    loop_len = cfg.search.max_new_sims
    print(f"[10] go9 dp=2 via cli.train on {card}: 2 gloo ranks on {r0['device']} "
          f"(10 x 128 bf16, {BATCH // 2} games and {BATCH // 2} train rows a rank; "
          f"env.max_steps=24); {len(r0['moves'])} self-play moves a rank ({loop_len} K1 and "
          f"{2 * loop_len} K2 launches each), both ranks left self-play on move "
          f"{r0['exits'][0][0]} with {r0['exits'][0][2]} games; self-play "
          + " / ".join(f"{x['selfplay_s'][0]:.2f}" for x in ranks) + " s, train generation "
          + " / ".join(f"{x['generation_s'][0]:.3f}" for x in ranks) + " s, fences "
          + " / ".join(f"{x['fence_s']:.4f}" for x in ranks) + f" s over {r0['fences']}; "
          + " / ".join(f"{x['train_step_ms']:.3f}" for x in ranks) + " ms per DP train step; "
          "peak memory " + " / ".join(f"{x['peak_memory_gib']:.2f}" for x in ranks)
          + f" GiB; {wall:.1f} s in cli.train", flush=True)
    update_err = check["update_rel_err"]
    print(f"[10] ranks bit-equal after training (train state and bf16 self-play net), "
          f"training_steps_10 restored bit-equal here; first DP step losses "
          f"{check['first_step_losses']} vs one process on both ranks' rows "
          f"{check['single_process_losses']} (max err {check['loss_err']:.2e} <= "
          f"{DP_LOSS_ATOL}); its weight update {update_err['ranks_vs_f32']:.4f} off the "
          f"float32 step's (relative), one process's bf16 step "
          f"{update_err['bf16_vs_f32']:.4f} off, DP vs one process bf16 "
          f"{update_err['ranks_vs_bf16']:.4f}; losses {check['losses']}", flush=True)
    print("[10] " + json.dumps(out), flush=True)
    shutil.rmtree(ckpt_dir)
    return out, [tuple(x["launches"]) for x in ranks]


def mdl_path(card, dev) -> dict:
    """[11]: ``cli.train.main`` with ``parallel.dp=1, parallel.mdl=2`` on the
    one card: two gloo ranks on ``cuda:0``, one model group, at go9 full
    width (the stem, the 20 block convs, ``policy_conv``, ``policy_fc`` and
    ``value_fc1`` split over the two; bf16, 200 sims, reuse,
    ``max_new_sims=120``), ``MDL_BATCH`` games, ``env.max_steps=5`` and a
    fence every move (so the games' 320 rows are counted on the 7th move),
    a train batch of ``MDL_TRAIN_BATCH``, one generation of 4 steps and one
    checkpoint, ``--no-eval``. The game length is the cut: two ranks sharing
    one H100 took ~3.5 ms for each of a move's 2,904 gathers (gloo's
    loopback transport), 14.2 s a move. ``parallel_run``'s checks (the first step's
    losses within ``MDL_LOSS_ATOL``), and: 24 gathers a net evaluation, the
    replicas' games, trees, replay rows, weights and net outputs with
    equal digests, each rank's slices equal to the gathered net's, and the
    checkpoint restored here into a whole bf16 net whose outputs on the
    first ``MDL_NET_ROWS`` replay rows are within ``MDL_NET_ATOL`` of the
    sharded net's. Returns the numbers and each rank's (K1, K2) launches."""
    import copy

    import torch

    from alpha_zero_tpu_torch.models.resnet import to_inference_dtype

    run_dir = os.path.join(HERE, "build", "chip_smoke_mdl")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt_dir, logs_dir = os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "logs")
    sets = ["parallel.dp=1", "parallel.mdl=2", f"parallel.selfplay_batch_size={MDL_BATCH}",
            f"train.batch_size={MDL_TRAIN_BATCH}", "env.max_steps=5", "parallel.fence_interval=1",
            f"train.min_games={MDL_BATCH}", f"train.games_per_ckpt={MDL_BATCH}",
            "train.ckpt_interval=4", "train.max_training_steps=4",
            f"run.ckpt_dir={ckpt_dir}", f"run.logs_dir={logs_dir}"]
    cfg, ranks, wall, check, restored = parallel_run("[11]", dev, sets, 4, MDL_BATCH,
                                                     MDL_LOSS_ATOL)
    r0 = ranks[0]
    if r0["mesh"] != [1, 2] or r0["sharded_layers"] != 24 or any(
            x["games_a_step"] != MDL_BATCH for x in ranks):
        raise SystemExit(f"[11] mesh {r0['mesh']}, {r0['sharded_layers']} sharded layers, "
                         f"games a rank {[x['games_a_step'] for x in ranks]}")
    if ranks[1]["digests"] != r0["digests"]:
        raise SystemExit(f"[11] the replicas differ: {r0['digests']} / {ranks[1]['digests']}")
    sharded = torch.load(os.path.join(logs_dir, "rank0", "net_outputs.pt"))
    whole = to_inference_dtype(copy.deepcopy(restored.net), cfg.network.inference_dtype).eval()
    with torch.no_grad():
        o = whole(sharded["rows"].to(dev))
    net_err = {"pi_logits": float((o.pi_logits.cpu() - sharded["pi_logits"]).abs().max()),
               "value": float((o.value.cpu() - sharded["value"]).abs().max()),
               "pi_logits_mean": float((o.pi_logits.cpu() - sharded["pi_logits"]).abs().mean()),
               "argmax_agree": float((o.pi_logits.argmax(-1).cpu()
                                      == sharded["pi_logits"].argmax(-1)).float().mean())}
    if max(net_err["pi_logits"], net_err["value"]) > MDL_NET_ATOL:
        raise SystemExit(f"[11] whole bf16 net from the checkpoint vs the sharded net on "
                         f"{MDL_NET_ROWS} replay rows: {net_err} (limit {MDL_NET_ATOL})")
    moves = len(r0["moves"])
    forwards = sum(f for _, _, f, _ in r0["moves"])
    out = {"config": "go9", "mesh": {"dp": 1, "mdl": 2},
           "reduced": {"env.max_steps": 5, "selfplay_batch": MDL_BATCH,
                       "train_batch": MDL_TRAIN_BATCH, "training_steps": 4},
           "ranks": 2, "backend": "gloo", "selfplay_moves": moves, "exits": r0["exits"],
           "selfplay_s": [x["selfplay_s"] for x in ranks],
           "s_per_move": [x["selfplay_s"][0] / moves for x in ranks],
           "gathers": [x["gathers"] for x in ranks], "gathers_a_forward": 24,
           "gather_s": [x["gather_s"] for x in ranks],
           "train_s": [x["generation_s"] for x in ranks],
           "train_step_ms": [x["train_step_ms"] for x in ranks],
           "peak_memory_gib": [x["peak_memory_gib"] for x in ranks],
           "launches": [x["launches"] for x in ranks], "net_err": net_err,
           "digests": r0["digests"], **check, "wall_s": wall}
    loop_len = cfg.search.max_new_sims
    update_err = check["update_rel_err"]
    print(f"[11] go9 dp=1 x mdl=2 via cli.train on {card}: 2 gloo ranks on {r0['device']}, "
          f"one model group (10 x 128 bf16, 24 of its layers split in two; {MDL_BATCH} games, "
          f"env.max_steps=5); {moves} self-play moves a rank ({loop_len} K1 and "
          f"{2 * loop_len} K2 launches and 24 gathers a net evaluation, {forwards} "
          f"evaluations), left self-play on move {r0['exits'][0][0]} with "
          f"{r0['exits'][0][2]} games; "
          + " / ".join(f"{s:.3f}" for s in out["s_per_move"]) + " s a move; gathers took "
          + " / ".join(f"{x['gather_s']:.2f}" for x in ranks) + " host s over the run "
          "(self-play, training, checkpoints); train generation "
          + " / ".join(f"{x['generation_s'][0]:.3f}" for x in ranks)
          + " s, " + " / ".join(f"{x['train_step_ms']:.3f}" for x in ranks)
          + f" ms per sharded train step at batch {MDL_TRAIN_BATCH}; peak memory "
          + " / ".join(f"{x['peak_memory_gib']:.2f}" for x in ranks)
          + f" GiB; {wall:.1f} s in cli.train", flush=True)
    print(f"[11] replicas equal (digests of games, trees, replay rows, weights, net outputs), "
          f"slices == the gathered net's, training_steps_4 restored bit-equal here; whole bf16 "
          f"net vs sharded on {MDL_NET_ROWS} replay rows: logits max {net_err['pi_logits']:.4g}"
          f" (mean {net_err['pi_logits_mean']:.3g}), value max {net_err['value']:.4g} (limit "
          f"{MDL_NET_ATOL}), argmax agreement {net_err['argmax_agree']:.4f}; first sharded "
          f"step losses {check['first_step_losses']} vs one process "
          f"{check['single_process_losses']} (err {check['loss_err']:.2e} <= {MDL_LOSS_ATOL}); "
          f"weight update {update_err['ranks_vs_f32']:.4f} off float32, one process bf16 "
          f"{update_err['bf16_vs_f32']:.4f}", flush=True)
    print("[11] " + json.dumps(out), flush=True)
    shutil.rmtree(ckpt_dir)
    return out, [tuple(x["launches"]) for x in ranks]


def dryrun_path(card, dev) -> dict:
    """[12]: ``dryrun_multichip(4, "cuda")``: four gloo ranks on ``cuda:0``,
    dp=2 x mdl=2, one train step and one self-play move (5 K1 and 10 K2
    launches in each rank, counted there); its OK line. Returns the
    numbers and each rank's (K1, K2) launches."""
    from alpha_zero_tpu_torch.parallel.dryrun import dryrun_config, dryrun_multichip

    t0 = time.time()
    result = dryrun_multichip(4, str(dev))
    wall = time.time() - t0
    loop_len = dryrun_config().search.num_simulations - 1
    launches = [tuple(r["launches"]) for r in result["ranks"]]
    if (result["dp"], result["mdl"]) != (2, 2) or set(launches) != {(loop_len, 2 * loop_len)}:
        raise SystemExit(f"[12] mesh dp={result['dp']} mdl={result['mdl']}, launches "
                         f"{launches}, expected ({loop_len}, {2 * loop_len}) in each rank")
    out = {"line": result["line"], "ranks": 4, "launches": launches, "wall_s": wall}
    print(f"[12] dry run on {card}: {result['line']} ({wall:.1f} s, 4 gloo ranks on "
          f"{dev}; {loop_len} K1 and {2 * loop_len} K2 launches in each rank)", flush=True)
    print("[12] " + json.dumps(out), flush=True)
    return out, launches


def replay_game(label, moves, result, dev, max_steps=GAME_STEPS):
    """Replays ``moves`` through the host ``GoEnv`` on ``dev``: black and
    white alternate, every move legal, the game over at the end with
    ``result``."""
    from alpha_zero_tpu_torch.envs.host import GoEnv

    env = GoEnv(board_size=9, komi=7.5, num_stack=8, max_steps=max_steps, device=dev)
    for i, (color, move) in enumerate(moves):
        if color != "BW"[i % 2] or env.is_game_over() or not env.is_legal_move(move):
            raise SystemExit(f"{label}: move {i} ({color} {move}) illegal on replay")
        env.step(move)
    if not env.is_game_over() or env.get_result_string() != result:
        raise SystemExit(f"{label}: replay ends {env.get_result_string()}, recorded {result}")


def match_path(card, dev, ckpt_dir) -> dict:
    """[9]: ``cli.match.main`` in-process between [8]'s checkpoints at go9
    full width (``env.max_steps=GAME_STEPS``), then one deterministic eval game;
    K1 and K2 against their plain versions on searched trees at B=1 and
    B=2, and timed at B=1 and B=64. Returns the numbers and the (K1, K2)
    launches of the match and of the eval game."""
    import csv

    import torch

    from alpha_zero_tpu_torch.cli import match as cli_match
    from alpha_zero_tpu_torch.cli.common import resolve_config
    from alpha_zero_tpu_torch.cli.play import load_variables
    from alpha_zero_tpu_torch.eval import evaluator as evaluator_lib
    from alpha_zero_tpu_torch.eval import match as match_lib
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.tools import dma_probe, select_bench
    from alpha_zero_tpu_torch.training.pipeline import build_engine
    from alpha_zero_tpu_torch.training.selfplay import make_eval_fn
    from alpha_zero_tpu_torch.utils import sgf as sgf_lib
    from alpha_zero_tpu_torch.utils.coords import CoordsConvertor
    from alpha_zero_tpu_torch.utils.device import graph_ms

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    black, white = (os.path.join(ckpt_dir, f"training_steps_{t}") for t in (10, TRAIN_STEPS))
    out_dir = os.path.join(HERE, "build", "chip_smoke_match")
    shutil.rmtree(out_dir, ignore_errors=True)
    sets = [f"env.max_steps={GAME_STEPS}"]
    cfg = resolve_config("go9", sets)
    sims = cfg.search.num_simulations

    # The match, counted ply by ply.
    plies = []
    make_match = match_lib.make_match_move_fn
    match_lib.make_match_move_fn = lambda *a, **k: counting(make_match(*a, **k), plies)
    k0 = (select.launches, writer.launches)
    t0 = time.time()
    try:
        cli_match.main(["--device", str(dev), "--config", "go9", "--black_ckpt", black,
                        "--white_ckpt", white, "--num_games", str(MATCH_GAMES), "--seed", "1",
                        "--save_match_dir", out_dir] + [x for v in sets for x in ("--set", v)])
    finally:
        match_lib.make_match_move_fn = make_match
    match_s = time.time() - t0
    match_launches = (select.launches - k0[0], writer.launches - k0[1])
    check_plies("[9] match", plies, sims)
    with open(os.path.join(out_dir, "log.csv")) as f:
        rows = list(csv.DictReader(f))
    if [int(r["game"]) for r in rows] != list(range(MATCH_GAMES)):
        raise SystemExit(f"[9] log.csv has {len(rows)} rows, expected {MATCH_GAMES}")
    cc = CoordsConvertor(9)
    t0 = time.time()
    for row in rows:
        with open(os.path.join(out_dir, f"game_{row['game']}.sgf")) as f:
            game = sgf_lib.parse_sgf(f.read())
        moves = [(c, cc.to_flat(cc.from_sgf(m))) for c, m in game.moves]
        if game.result != row["game_result"] or len(moves) != int(row["game_length"]):
            raise SystemExit(f"[9] game {row['game']}: SGF != log.csv")
        replay_game(f"[9] match game {row['game']}", moves, row["game_result"], dev)
    replay_s = time.time() - t0
    results = [r["game_result"] for r in rows]

    # One deterministic eval game between the same checkpoints.
    engine = build_engine(cfg.env)
    black_net, white_net = (load_variables(cfg, path, dev) for path in (black, white))
    eval_plies = []
    k0 = (select.launches, writer.launches)
    stats = evaluator_lib.play_eval_game(
        engine, counting(evaluator_lib.make_eval_move_fn(engine, cfg.search), eval_plies),
        black_net, white_net, dev)
    eval_launches = (select.launches - k0[0], writer.launches - k0[1])
    check_plies("[9] eval game", eval_plies, sims)
    replay_game("[9] eval game", stats["moves"], stats["game_result"], dev)

    # K1 and K2 on searched trees at B=1 and B=2 (bit-equal), and at B=1
    # and B=64 (timed): fresh go9 searches with the step-20 net from
    # positions 6 random moves in.
    gen = torch.Generator(device=dev).manual_seed(12)
    kw = dict(path_cap=min(sims + 1, engine.max_steps + 2),
              c_puct_base=cfg.search.c_puct_base, c_puct_init=cfg.search.c_puct_init)
    times = {}
    for b in (1, 2, MATCH_GAMES):
        states = engine.init_batch(b, device=dev)
        for _ in range(6):
            pick = torch.multinomial(states.legal[:, :-1], 1, generator=gen)[:, 0]
            states = engine.step_batch(states, pick.to(torch.int32))
        _, tree = mcts.batched_search(make_eval_fn(white_net), engine, states, sims,
                                      return_trees=True)
        args = select_bench.select_args(tree)
        t = tree.node_N.shape[1]
        widx = torch.where(tree.num_nodes < t, tree.num_nodes, -1.0).to(torch.int32)
        arrays = mcts.materialize_arrays(tree)
        rows_ = [torch.randint(-100, 100, (b,) + a.shape[2:], generator=gen,
                               device=dev).to(a.dtype) for a in arrays]
        if b < MATCH_GAMES:
            got, ref = select(*args, **kw), tree_kernels.select_leaf_plain(*args, **kw)
            torch.cuda.synchronize()
            for name, o, r in zip(select_bench.OUTPUTS, got, ref):
                if o.dtype != r.dtype or not torch.equal(o, r):
                    raise SystemExit(f"[9] select kernel != plain at B={b}: {name}")
            for label, arr in (("materialize", arrays),
                               ("expand", [tree.child_P, tree.node_expanded])):
                rr = rows_ if label == "materialize" else [
                    torch.rand((b,) + tree.child_P.shape[2:], generator=gen, device=dev),
                    torch.ones(b, dtype=torch.bool, device=dev)]
                for w in (torch.zeros_like(widx) + 1, torch.full_like(widx, -1)):
                    dma_probe.check_writer(writer, arr, rr, w)
            print(f"[9] K1 and K2 bit-equal to their plain versions on a searched go9 "
                  f"tree at B={b} (depth max {int(ref[6].max())}; K2 on the materialize "
                  f"and expand sets)", flush=True)
        if b != 2:
            times[b] = {"K1": select_bench.time_select(select, args, kw, 50),
                        "K2": graph_ms(lambda: writer(arrays, rows_, widx), 50)}
    out = {"config": "go9", "reduced": {"env.max_steps": GAME_STEPS}, "match_games": MATCH_GAMES,
           "match_s": match_s, "match_game_s": match_s / MATCH_GAMES,
           "match_plies": len(plies),
           "match_ply_s": sum(t for _, _, t in plies) / len(plies),
           "black_wins": sum(r.startswith("B+") for r in results),
           "white_wins": sum(r.startswith("W+") for r in results),
           "replay_s": replay_s, "eval_game": {k: v for k, v in stats.items() if k != "moves"},
           "eval_game_plies": len(eval_plies),
           "eval_ply_s": sum(t for _, _, t in eval_plies) / len(eval_plies),
           "k1_ms": {b: v["K1"] for b, v in times.items()},
           "k2_ms": {b: v["K2"] for b, v in times.items()}}
    print(f"[9] go9 cli.match (10 x 128, bf16; env.max_steps={GAME_STEPS} the only cut) on {card}: "
          f"{MATCH_GAMES} games of training_steps_10 (black) vs _{TRAIN_STEPS} in "
          f"{match_s:.1f} s ({match_s / MATCH_GAMES:.3f} s per game, {len(plies)} plies of "
          f"{out['match_ply_s']:.3f} s, {sims - 1} K1 and {2 * (sims - 1)} K2 launches "
          f"each); black {out['black_wins']}, white {out['white_wins']}; every move legal "
          f"on a host-env replay ({replay_s:.1f} s), results == log.csv. Eval game: "
          f"{stats['game_result']} in {len(eval_plies)} plies of {out['eval_ply_s']:.3f} s",
          flush=True)
    print(f"[9] K1 (graph, warm) at B=1 {times[1]['K1']['ms'] * 1e3:.2f} us, at "
          f"B={MATCH_GAMES} {times[MATCH_GAMES]['K1']['ms'] * 1e3:.2f} us; K2 materialize "
          f"set at B=1 {times[1]['K2'] * 1e3:.2f} us, at B={MATCH_GAMES} "
          f"{times[MATCH_GAMES]['K2'] * 1e3:.2f} us, on {card}", flush=True)
    print("[9] " + json.dumps(out), flush=True)
    shutil.rmtree(out_dir)
    return out, match_launches, eval_launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, HERE)
    import alpha_zero_tpu_torch

    if os.path.dirname(os.path.dirname(alpha_zero_tpu_torch.__file__)) != HERE:
        raise SystemExit("chip_smoke: alpha_zero_tpu_torch must sit beside this script")

    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.envs.go import GoEngine
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.ops import _build, scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.tools import dma_probe, select_bench
    from alpha_zero_tpu_torch.training import selfplay
    from alpha_zero_tpu_torch.training.pipeline import build_engine
    from alpha_zero_tpu_torch.utils.device import card_line, time_ms

    # Float32 reference checks below compare with the CPU: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # --- 2. Build every kernel (one nvcc per source, all at once).
    t0 = time.time()
    reports = _build.build_all()
    print(f"[2] built {_build.sources()} in {time.time() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"    {name}: {line.strip()}")

    cfg = config_lib.go9()
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device=dev, seed=0)

    # --- 3. K1 (select) against its plain version on the same trees.
    select = tree_kernels.select_leaf_batched
    names = select_bench.OUTPUTS
    max_err = 0.0

    def check_select(label, args, kw):
        nonlocal max_err
        out = select(*args, **kw)
        ref = tree_kernels.select_leaf_plain(*args, **kw)
        torch.cuda.synchronize()
        for name, o, r in zip(names, out, ref):
            if o.dtype != r.dtype or not torch.equal(o, r):
                raise SystemExit(f"select kernel != plain on {label}: {name}")
            max_err = max(max_err, float((o.double() - r.double()).abs().max()))
        b, t, a = args[6].shape
        depth = ref[6]
        print(f"[3] select bit-equal to plain: {label} B={b} T={t} A={a} "
              f"path_cap={kw['path_cap']} depth mean {depth.double().mean():.2f} "
              f"max {int(depth.max())}", flush=True)
        return ref

    for label, (batch, sims, mns) in (("go9", (BATCH, 200, 120)),
                                      ("ragged", (37, 16, 8))):
        trees, path_cap = select_bench.grown_trees(cfg, engine, net, batch, sims, mns,
                                                   seed=7, device=dev)
        kw = dict(path_cap=path_cap, c_puct_base=cfg.search.c_puct_base,
                  c_puct_init=cfg.search.c_puct_init)
        for which, tree in zip(("carried", "searched"), trees):
            ref = check_select(f"{label} {which}", select_bench.select_args(tree), kw)
        if label == "go9":
            go9_tree = trees[1]
            args = select_bench.select_args(go9_tree)
            times = select_bench.time_select(select, args, kw, 50)
            plain_ms = time_ms(lambda: tree_kernels.select_leaf_plain(*args, **kw), 5)
            bound = select_bench.select_bound(ref[6], *go9_tree.child_P.shape)
            print(f"[3] select at go9 shapes on {card}: graph {times['ms']:.5f} ms warm, "
                  f"{times['cold_ms']:.5f} ms with L2 flushed, back to back "
                  f"{times['back_to_back_ms']:.5f} ms; plain {plain_ms:.4f} ms, bound "
                  f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}: "
                  f"{bound['bytes'] / 1e6:.2f} MB, {bound['ops'] / 1e6:.1f} M ops)",
                  flush=True)
    # Synthetic trees (every kind of lane: chains, ties, ±0.0 priors, a
    # terminal child, an unexpanded root, random) at the tree shapes of
    # gomoku13 and go19_jumbo, the chains whole and cut by path_cap.
    for label, t, a in (("gomoku13", 381, 169), ("go19_jumbo", 801, 362)):
        arrays = select_bench.synthetic_trees(64, t, a, seed=5)
        args = tuple(torch.from_numpy(arrays[f]).to(dev) for f in select_bench.FIELDS)
        for path_cap in (t, t // 2):
            check_select(f"synthetic {label}", args,
                         dict(path_cap=path_cap, c_puct_base=cfg.search.c_puct_base,
                              c_puct_init=cfg.search.c_puct_init))

    # --- 4. The port on the card against its CPU path, on small inputs.
    small = GoEngine(board_size=9, num_stack=8)
    rng = torch.Generator().manual_seed(3)
    s_gpu, s_cpu = small.init_batch(64, device=dev), small.init_batch(64, device="cpu")
    for i in range(60):
        weights = s_cpu.legal.clone()
        weights[:, small.pass_move] = 0.02  # rare passes; the only move when done
        moves = torch.multinomial(weights, 1, generator=rng)[:, 0].to(torch.int32)
        s_cpu = small.step_batch(s_cpu, moves)
        s_gpu = small.step_batch(s_gpu, moves.to(dev))
        on_card = s_gpu.to_numpy()
        for key, val in s_cpu.to_numpy().items():
            if not (on_card[key] == val).all():
                raise SystemExit(f"engine on the card != CPU at move {i}: {key}")
    five = GoEngine(board_size=5, num_stack=4)
    prior = torch.softmax(torch.randn(five.num_actions, generator=rng), 0)

    def fixed_eval(obs):
        return prior.to(obs.device).expand(obs.shape[0], -1), torch.zeros(
            obs.shape[0], device=obs.device)

    roots = five.init_batch(8, device="cpu")
    r_cpu = mcts.batched_search(fixed_eval, five, roots, 16)
    r_gpu = mcts.batched_search(fixed_eval, five, roots.map(lambda x: x.to(dev)), 16)
    if not torch.equal(r_cpu.child_N, r_gpu.child_N.cpu()):
        raise SystemExit("search on the card != CPU (fixed priors)")
    small_net_cfg = dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                        num_fc_units=16, inference_dtype="float32")
    cpu_net = build_network(cfg.env, small_net_cfg, device="cpu", seed=1)
    gpu_net = build_network(cfg.env, small_net_cfg, device=dev, seed=1)
    obs = engine.observation(s_cpu)
    with torch.no_grad():
        o_cpu, o_gpu = cpu_net(obs), gpu_net(obs.to(dev))
    net_err = max(float((o_cpu.pi_logits - o_gpu.pi_logits.cpu()).abs().max()),
                  float((o_cpu.value - o_gpu.value.cpu()).abs().max()))
    if net_err > 1e-4:
        raise SystemExit(f"float32 net on the card != CPU: {net_err}")
    print(f"[4] card == CPU: engine (64 games x 60 moves, exact), search "
          f"(5x5, 16 sims, child_N exact), f32 net (max err {net_err:.2e})", flush=True)

    # --- 5. The main path: go9 self-play moves.
    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    select.launches = writer.launches = 0
    rate, _, move_kernels = play_moves("[5] go9", cfg, engine, net, 1 + TIMED_MOVES, dev,
                                       profiled=True)
    launches = {"go9_selfplay": (select.launches, writer.launches)}
    loop_len = cfg.search.max_new_sims
    print(f"[5] go9 self-play B={BATCH} 200 sims reuse max_new_sims={loop_len}: "
          f"{rate:.1f} env-steps/s ({BATCH / rate:.3f} s/move over {TIMED_MOVES} "
          f"moves after 1 warm-up) on {card}; {select.launches} select launches "
          f"({loop_len}/move), {writer.launches} tree-row writer launches "
          f"({2 * loop_len}/move); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"[5] one more go9 move under torch.profiler: {move_kernels} device kernel "
          f"launches (kernels, copies and memsets; {loop_len} K1 and {2 * loop_len} K2 "
          f"among them)", flush=True)

    # --- 6. K2/K3 (row scatter) against their plain version, then the probe.
    scatters = (scatter_kernels.scatter_rows, scatter_kernels.scatter_rows_bulk)
    blend = scatter_kernels.blend_scatter
    sgen = torch.Generator(device=dev).manual_seed(11)
    scatter_err = {k.__name__: 0.0 for k in scatters}

    def check_scatter(label, arr, rows, widx, kernels, ref=None):
        ref = blend(arr, rows, widx) if ref is None else ref
        for kernel in kernels:
            got = kernel(arr.clone(), rows, widx)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"{kernel.__name__} != plain on {label}")
            err = float((got.double() - ref.double()).abs().max())
            scatter_err[kernel.__name__] = max(scatter_err[kernel.__name__], err)
        print(f"[6] {' and '.join(k.__name__ for k in kernels)} bit-equal on {label} "
              f"B={arr.shape[0]} T={arr.shape[1]} W={arr.shape[2]}", flush=True)

    for label, b, t, widths in (("go9", BATCH, 201, (82, 128)),
                                ("gomoku13", BATCH, 381, (169, 256)),
                                ("ragged", 37, 17, (12,))):
        for w in widths:
            arr = torch.randn((b, t, w), generator=sgen, device=dev)
            rows = torch.randn((b, w), generator=sgen, device=dev)
            if label == "ragged":  # lanes that write nothing: widx < 0 or >= T
                widx = torch.randint(-3, t + 3, (b,), generator=sgen, device=dev)
                widx[:3] = torch.tensor([-1, t, t + 2])
                widx = widx.to(torch.int32)
            else:
                widx = torch.randint(0, t, (b,), generator=sgen, device=dev,
                                     dtype=torch.int32)
            check_scatter(f"{label} vs blend_scatter", arr, rows, widx,
                          scatters if w % 4 == 0 else scatters[:1])
    # The tree-row writer K2 against its plain version: the searched go9
    # tree of [3] with rows for its next materialize and expand writes,
    # synthetic go19-shaped arrays (int16 labels/liberties, 722/724-byte
    # rows), and B=37 with 1-byte and odd-address rows; K3 on rows of whole
    # 16-byte units. widx is ragged: -1, T and T + 2 among the lanes.
    def ragged(b, t, base=None):
        widx = torch.randint(-3, t + 3, (b,), generator=sgen, device=dev)
        if base is not None:
            widx = torch.where(torch.rand(b, generator=sgen, device=dev) < 0.9, base, widx)
        widx[:3] = torch.tensor([-1, t, t + 2])
        return widx.to(torch.int32)

    def random_rows(arr):
        shape = (arr.shape[0],) + arr.shape[2:]
        if arr.dtype.is_floating_point:
            return torch.randn(shape, generator=sgen, device=dev).to(arr.dtype)
        return torch.randint(-100, 100, shape, generator=sgen, device=dev).to(arr.dtype)

    def check_set(label, kernel, arrays, rows, widx):
        for w in (widx, torch.full_like(widx, -1)):
            dma_probe.check_writer(kernel, arrays, rows, w)
        torch.cuda.synchronize()
        print(f"[6] {kernel.__name__} bit-equal to write_rows_plain on {label}: "
              f"{len(arrays)} arrays, {dma_probe.lane_bytes(rows)} B a lane, "
              f"B={widx.shape[0]}, {int(((widx >= 0) & (widx < arrays[0].shape[1])).sum())} "
              f"lanes writing", flush=True)

    def check_tree(label, tree):
        """K2 on a searched tree's materialize and expand sets, with random
        rows for its next writes."""
        b, t = tree.node_N.shape
        next_slot = torch.where(tree.num_nodes < t, tree.num_nodes, -1.0).long()
        for name, arrays in (("materialize", mcts.materialize_arrays(tree)),
                             ("expand", [tree.child_P, tree.node_expanded])):
            check_set(f"{label}, {name} set", writer, arrays,
                      [random_rows(x) for x in arrays], ragged(b, t, next_slot))

    check_tree("go9 searched tree", go9_tree)
    b, t = go9_tree.node_N.shape
    go19 = dma_probe.tree_sets(128, 801, 362, sgen, dev)
    check_set("synthetic go19 sets (int16 722/724-byte rows)", writer,
              go19["materialize"][0] + go19["expand"][0],
              go19["materialize"][1] + go19["expand"][1], ragged(128, 801))
    del go19
    odd = [torch.randint(-100, 100, (37 * 17 * n + 1,), generator=sgen,
                         device=dev).to(dtype)[1:].view((37, 17) + shape)
           for n, shape, dtype in ((1, (), torch.int8), (1, (), torch.bool),
                                   (3, (3,), torch.int8))]
    check_set("B=37, 1- and 3-byte rows at odd addresses", writer, odd,
              [random_rows(x) for x in odd], ragged(37, 17))
    units = [torch.randint(-100, 100, (b, t) + shape, generator=sgen,
                           device=dev).to(dtype)
             for shape, dtype in (((128,), torch.float32), ((16,), torch.int8),
                                  ((8,), torch.int16))]
    check_set("16-byte rows at go9's B and T", scatter_kernels.write_rows_bulk, units,
              [random_rows(x) for x in units], ragged(b, t))

    counted = (writer, scatter_kernels.write_rows_bulk)
    for kernel in counted:
        kernel.launches = 0
    go9_probe = dma_probe.run_probe(BATCH, 201, engine.num_actions, 50, device=dev)
    scatter_launches = {k.__name__: k.launches for k in counted}
    for name, count in scatter_launches.items():
        if count == 0:
            raise SystemExit(f"the probe run launched {name} no time")
    dma_probe.run_probe(BATCH, 381, 169, 50, device=dev)
    print(f"[6] probe launches at go9: {scatter_launches}", flush=True)

    def probe_line(name):
        (line,) = [x for x in go9_probe["lines"]
                   if x["name"] == name and x["width"] == go9_probe["apad"]]
        return line

    def set_line(name, set_name):
        (line,) = [x for x in go9_probe["sets"] if x["name"] == name and x["set"] == set_name]
        return line

    mat, exp = set_line("write_rows", "materialize"), set_line("write_rows", "expand")
    print(f"[6] K2 at go9 on {card}: materialize set graph {mat['graph_ms']:.5f} ms warm, "
          f"{mat['cold_ms']:.5f} cold, {mat['ms']:.5f} back to back, bound "
          f"{mat['bound_ms']:.6f}, launch floor "
          f"{set_line('launch_floor', 'materialize')['graph_ms']:.5f}; put_rows x13 "
          f"{set_line('put_rows', 'materialize')['graph_ms']:.5f}. Expand set "
          f"{exp['graph_ms']:.5f} warm, {exp['cold_ms']:.5f} cold; put_rows x2 "
          f"{set_line('put_rows', 'expand')['graph_ms']:.5f}", flush=True)

    # --- 7. gomoku13 self-play: K1 and K2 at T=381, A=169 on a real search.
    g_cfg = config_lib.gomoku13()
    g_engine = build_engine(g_cfg.env)
    g_net = build_network(g_cfg.env, g_cfg.network, device=dev, seed=0)
    select.launches = writer.launches = 0
    g_rate, g_sp, _ = play_moves("[7] gomoku13", g_cfg, g_engine, g_net, 1 + GOMOKU_TIMED_MOVES,
                              dev)
    launches["gomoku13_selfplay"] = (select.launches, writer.launches)
    g_loop = g_cfg.search.max_new_sims
    print(f"[7] gomoku13 self-play B={BATCH} 380 sims reuse max_new_sims={g_loop} "
          f"(10 x 40 net, bf16, padding-3 stem): {g_rate:.1f} env-steps/s "
          f"({BATCH / g_rate:.3f} s/move over {GOMOKU_TIMED_MOVES} moves after 1 "
          f"warm-up) on {card}; {select.launches} select launches ({g_loop}/move), "
          f"{writer.launches} tree-row writer launches ({2 * g_loop}/move)", flush=True)
    check_tree("gomoku13 searched tree (int16 2-byte labels/liberties rows)", g_sp.trees)
    del g_sp
    check_engine_on_card("[7]", g_engine, 64, dev)

    # --- 8. The training path: cli.train at go9 full width, the evaluator on.
    select.launches = writer.launches = 0
    train, ckpt_dir = train_path(card, dev)
    eval_k1, eval_k2 = train["eval_launches"]
    launches["go9_training"] = (select.launches - eval_k1, writer.launches - eval_k2)

    # --- 9. Matches between [8]'s checkpoints: cli.match and an eval game.
    select.launches = writer.launches = 0
    matches, match_launches, game_launches = match_path(card, dev, ckpt_dir)
    shutil.rmtree(ckpt_dir)  # 24 MB a checkpoint; the CSVs stay
    launches["go9_eval"] = (eval_k1 + game_launches[0], eval_k2 + game_launches[1])
    launches["go9_match"] = match_launches

    # --- 10. Data parallel: cli.train with parallel.dp=2, two ranks on the card.
    select.launches = writer.launches = 0
    dp, rank_launches = dp_path(card, dev)
    launches["go9_dp2"] = tuple(sum(x) for x in zip(*rank_launches))

    # --- 11. The model axis: cli.train with parallel.mdl=2, two ranks on the card.
    select.launches = writer.launches = 0
    _, mdl_launches = mdl_path(card, dev)
    launches["go9_mdl2"] = tuple(sum(x) for x in zip(*mdl_launches))

    # --- 12. The dry run: dp=2 x mdl=2, four ranks on the card.
    select.launches = writer.launches = 0
    _, dryrun_launches = dryrun_path(card, dev)
    launches["dryrun"] = tuple(sum(x) for x in zip(*dryrun_launches))

    # Device times from the probe's CUDA-graph replays; K2's at the go9
    # materialize set (13 arrays: no single PyTorch call writes them), with
    # the expand set and the single f32 array (vs index_copy_) beside it.
    scatter_entries = [{
        "name": "write_rows",
        "route": "cuda",
        "source": "alpha_zero_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "tools/dma_probe.py:44",
        "launches": sum(w for _, w in launches.values()),
        "launches_by_path": {k: w for k, (_, w) in launches.items()},
        "launches_by_rank_go9_dp2": [w for _, w in rank_launches],
        "launches_by_rank_go9_mdl2": [w for _, w in mdl_launches],
        "probe_launches": scatter_launches["write_rows"],
        "max_abs_err": scatter_err["scatter_rows"],
        "ms": mat["graph_ms"],
        "cold_ms": mat["cold_ms"],
        "back_to_back_ms": mat["ms"],
        "launch_floor_ms": set_line("launch_floor", "materialize")["graph_ms"],
        "plain_ms": set_line("put_rows", "materialize")["graph_ms"],
        "bound_ms": mat["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "b1_ms": matches["k2_ms"][1],
        f"b{MATCH_GAMES}_ms": matches["k2_ms"][MATCH_GAMES],
        "expand_ms": exp["graph_ms"],
        "expand_cold_ms": exp["cold_ms"],
        "expand_plain_ms": set_line("put_rows", "expand")["graph_ms"],
        "expand_bound_ms": exp["bound_ms"],
        "f32_row_ms": probe_line("scatter_rows")["graph_ms"],
        "f32_row_bound_ms": probe_line("scatter_rows")["bound_ms"],
        "f32_row_library_ms": probe_line("index_copy_")["graph_ms"],
    }, {
        "name": "write_rows_bulk",
        "route": "cuda",
        "source": "alpha_zero_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "tools/dma_probe.py:83",
        "launches": scatter_launches["write_rows_bulk"],
        "max_abs_err": scatter_err["scatter_rows_bulk"],
        "ms": probe_line("scatter_rows_bulk")["graph_ms"],
        "back_to_back_ms": probe_line("scatter_rows_bulk")["ms"],
        "plain_ms": probe_line("blend_scatter")["graph_ms"],
        "bound_ms": probe_line("scatter_rows_bulk")["bound_ms"],
        "bound_by": "bytes",
        "library_ms": probe_line("index_copy_")["graph_ms"],
    }]

    print(json.dumps({"kernels": [{
        "name": "select_leaf",
        "route": "cuda",
        "source": "alpha_zero_tpu_torch/csrc/select_leaf.cu",
        "replaces": "alpha_zero_tpu/ops/tree_kernels.py:58",
        "launches": sum(k1 for k1, _ in launches.values()),
        "launches_by_path": {k: k1 for k, (k1, _) in launches.items()},
        "launches_by_rank_go9_dp2": [k1 for k1, _ in rank_launches],
        "launches_by_rank_go9_mdl2": [k1 for k1, _ in mdl_launches],
        "max_abs_err": max_err,
        "ms": times["ms"],
        "cold_ms": times["cold_ms"],
        "back_to_back_ms": times["back_to_back_ms"],
        "b1_ms": matches["k1_ms"][1]["ms"],
        f"b{MATCH_GAMES}_ms": matches["k1_ms"][MATCH_GAMES]["ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,
    }] + scatter_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
