"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``alpha_zero_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, checks the port on the
card against its CPU path on small inputs, then drives the port's paths:

- [5] go9 self-play (9x9 Go, 10 blocks x 128 filters in bf16 with random
  weights of seed 0, 200 simulations, subtree reuse, max_new_sims=120) at
  B=1024 games through the self-play bench (``tools/bench.py:run``, the
  port of ``bench.py``, over ``init_selfplay_state`` and
  ``make_selfplay_step``), ``TIMED_MOVES`` timed moves after one warm-up:
  its JSON lines as ``bench.py`` prints them, every select through the
  select kernel K1 (120 launches a move), every tree write through the
  tree-row writer K2 (2 a simulation, 240 a move), every timed move's
  ``search_pi``, ``root_visits``, values and legality.
- [6] K2 and K3 bit-equal to their plain versions on the searched go9
  tree's materialize and expand sets, go19-shaped int16 rows and 1-byte
  rows, then the row-scatter probe
  (``alpha_zero_tpu_torch/tools/dma_probe.py:run_probe``, the entry point
  of K3 and the timer of both) at go9 and gomoku13 tree shapes.
- [7] gomoku13 self-play (13x13 Gomoku, 10 x 40 net in bf16, padding-3
  stem, 380 simulations, reuse, max_new_sims=240) at B=1024 through the
  bench as in [5], ``GOMOKU_TIMED_MOVES`` timed moves: 240 K1 and 480 K2
  launches a move, K2 bit-equal on the searched tree's sets (int16 2-byte
  rows), the Gomoku engine on the card equal to its CPU path.
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
  train rows a rank, ``env.max_steps=GAME_STEPS``, one generation of 10
  steps, ``--no-eval``: 120 K1 and 240 K2 launches in every move of each rank,
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
- [13] ``cli.analysis`` through its ``main``: ``params --device cuda``
  (all four configs' nets built on the card, the counts equal to the
  CPU's), ``score-demo --device cuda`` (the seven boards in one batched
  ``area_counts`` call, bit-equal to the CPU's) and ``puct``. Not
  ``aggregate-*``, ``filter-sgf`` or ``cli.plot``: they need pandas or
  matplotlib, which the card's machine lacks (the CPU tests hold them to
  the JAX package). Then ``cli.play.main(["--config", "go19_jumbo",
  "--ai_vs_ai", "--device", "cuda"])``, the GUI's AI-vs-AI game at full
  width (19 x 256 bf16 net of seed 0, 800 simulations on fresh trees,
  T=801, A=362, B=1) for ``GUI_PLIES`` plies, under ``fake_tkinter``, a
  recording stand-in for the ``tkinter`` module (the machine has no
  display): it replaces the display, never the device, and the AI's
  searches run on the card through K1 and K2. Checked: 799 K1 and 1,598 K2
  launches a ply, every move accepted by the host ``GoEnv`` and replayed
  to the same board by a fresh one on the CPU, the board and header drawn
  after each ply; seconds a ply and peak memory (above what earlier phases
  hold); K1 and K2 bit-equal to their plain versions on the last ply's
  searched tree and timed there.
- [14] go19_jumbo at its own scale: ``cli.train.main(["--config",
  "go19_jumbo", "--no-eval", ...])`` in-process (B=2048 self-play games,
  19 x 256 bf16 net of seed 0, 800 simulations with max_new_sims=480 on
  trees of T=801, A=362, train batch 2048 at lr 0.2), cut only in length
  (``env.max_steps=JUMBO_GAME_STEPS``, one generation of 2048 games and
  ``JUMBO_TRAIN_STEPS`` steps; the Trainer harvests two steps behind its
  dispatch, so it plays four moves): 480 K1 and 960 K2 launches a move,
  every move legal and every game scored alike on a lockstep replay by the
  engine on the CPU, ``search_pi`` rows summing to 1, the replay, finite
  losses, the checkpoint restored bit-equal, the self-play net equal to the
  master weights; seconds a move, ms a train step (CUDA events, warm, the
  self-play trees resident), peak memory of self-play and of the train
  steps; the recompute BatchNorm bit-equal to the formulation it replaced
  (``kept_bn_forward``) at batch ``BN_CHECK_BATCH``, cuDNN deterministic;
  K1 and K2 bit-equal to their plain versions on all 2048 lanes of move 2's
  searched tree and timed there.
- [15] the engine parity sweep (``tools/device_parity.py:sweep``, the port
  of the JAX tool): identical random games, the JAX tool's moves, through
  ``step_batch`` on the card and on the CPU, every analysis field after
  every step, at each board of ``SWEEPS`` (go9 and gomoku13 at B=256-4096,
  go19 at B=256-2048); every batch OK, stones captured at go9 and go19.
  Then K4 (``ops/score_kernels.py:score_area``, terminal scoring) against
  the plain scoring on the card, at each of ``SCORE_CHECKS``: played
  positions (``tools/score_boards.py``) and the snake boards, every lane
  bit-equal with and without a mask; K4's device time (CUDA graph, warm)
  beside its byte bound and the plain version's time.
- [16] the backfill evaluator (``tools/backfill_eval.py:backfill``) on
  [8]'s checkpoints with [8]'s config (``eval_games=2``, its pro games and
  dataset cache): the JAX package's header, every column but ``datetime``
  equal to [8]'s in-run ``evaluation.csv`` rows, 199 K1 and 398 K2 launches
  every ply; then a metrics-only pass (batch 8192) within
  ``METRICS_ONLY_RTOL`` and ``METRICS_ONLY_FLIPS`` of those rows' pro
  metrics.
- [17] the root-visit histogram (``tools/visits_hist.py``) at go9, B=1024,
  ``VISITS_WARM`` warm and ``VISITS_STEPS`` measured moves with random
  weights of seed 0: 120 K1 and 240 K2 launches a move, every N_root in
  [1, 200], the histogram's shares summing to 1; prints the report.
- [18] the self-play bench at go19_jumbo (``JUMBO_BENCH``: full width and
  game length, 256 games), checked as in [5] with 480 K1 and 960 K2
  launches a move; then ``tools/bench_torch.py`` as a subprocess with
  ``BENCH_DP=2`` at ``BENCH_DP_RUN`` (two gloo ranks on the card): its
  lines and each rank's launches a move.

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
kernels' launch counts are set to 0 before each of [5], [7], [8], [9],
[13], [14], [16], [17], [18]'s go19_jumbo run and [10], [11] and [12] (in
each of their ranks) and read after it;
``launches`` sums them,
``launches_by_path`` splits them (``go9_selfplay`` is [5]'s bench,
``gomoku13_selfplay`` [7]'s bench, ``go9_training`` [8]'s self-play and
profiled move, ``go9_eval`` its evaluation plies and [9]'s eval game,
``go9_match`` the ``cli.match`` run, ``go9_dp2`` [10]'s two ranks,
``go9_mdl2`` [11]'s and ``dryrun`` [12]'s four, each counted in its own
process and carried back, ``go19_gui`` [13]'s GUI game, ``go19_b2048``
[14]'s self-play, ``go9_backfill`` [16]'s evaluation plies, ``go9_visits``
[17]'s moves, ``go19_jumbo_bench`` [18]'s in-process run,
``go9_bench_dp2`` the timed moves of [18]'s two ranks, summed from the
CLI's stderr line: their warm-up move runs in the ranks, uncounted).
``go19_jumbo_b1_*`` are K1's and K2's times on [13]'s
searched tree, ``go19_jumbo_b2048_*`` on [14]'s.

Every phase raises on failure; there is no CPU fallback. The line before
the last is the card's name and power limit; the line before that is one
JSON object with each kernel's launches, error and times, and before that
come the seconds of each phase; the last line is
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
# [5] and [7] run the self-play bench at go9 and gomoku13, B=1024: this
# many timed moves after one warm-up (go9: bench.py's default).
TIMED_MOVES = 8
GOMOKU_TIMED_MOVES = 4
TRAIN_STEPS = 20
MATCH_GAMES = 64
# [8]'s, [9]'s and [10]'s games end at this many moves. 24 until the model
# axis added [11] and [12]: their evaluations and matches, launch-bound at
# 2-4 s a ply, took 600 s of a 1287 s run on a slower card, past the 1200 s
# the script has. [10] kept 24 until [13] added go19_jumbo's GUI game; 12
# until [14] added go19_jumbo's self-play (237 s on an NVIDIA H100 80GB
# HBM3 at 700.00 W); 8 until [18] added the bench, when a run on a slow
# host (a B=1 ply 3.85-4.27 s, against 2.67 s) took 1154.8 s, the
# evaluations of [8] and [16] 262 s of it.
GAME_STEPS = 6
# [13]'s AI-vs-AI game stops after one move of each side: a go19_jumbo ply
# is an 800-simulation search at B=1, launch-bound like go9's 2-4 s ply.
GUI_PLIES = 2
# [14] runs go19_jumbo at its own widths (B=2048 games, 800 simulations with
# max_new_sims=480, train batch 2048) cut in length only: games of two
# moves (the second searches a rerooted tree) and one generation of two
# train steps, timed after the run on two more.
JUMBO_GAME_STEPS = 2
JUMBO_TRAIN_STEPS = 2
# [14] holds the recompute BatchNorm to the formulation it replaced on a
# batch where the latter's float32 copies fit beside everything else.
BN_CHECK_BATCH = 256
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
# [15] sweeps the engines on the card against the CPU at these boards,
# batch sizes and step counts (game, board, batches, steps): long enough
# for captures at go9 and go19 (60 random go19 steps at B=2048 capture, 20
# do not), finished games at gomoku13. go9 ran 120 steps until [18] was
# added (captures in every batch and ko from B=256 on).
SWEEPS = (("go", 9, (256, 1024, 2048, 4096), 60),
          ("gomoku", 13, (256, 1024, 2048, 4096), 60),
          ("go", 19, (256, 1024, 2048), 60))
# [15] holds K4 to the plain scoring at the benchmark cells' boards and
# batches (board, batch, plies of the played positions; the last 6 lanes
# are the snake boards) and masks a tenth of the lanes in, about what a
# search step finds ended.
SCORE_CHECKS = ((9, 4096, 60), (19, 512, 240))
SCORE_MASKED = 0.1
# [16]'s metrics-only pass runs the bf16 net over the pro positions in
# batches of 8192 where [8]'s rows ran 1024: the float32 sums of value error
# and entropy come in another order (1.6e-6 relative apart on an NVIDIA
# H100 80GB HBM3 at 700.00 W, no top-k hit flipped), and cuDNN may pick
# another kernel for another batch, which can round a bf16 activation the
# other way and flip a near-tied top-k hit. The value error and entropy
# (means over 10,454 positions) must stay within METRICS_ONLY_RTOL of the
# rows', each top-k accuracy within METRICS_ONLY_FLIPS positions; the
# weights of another checkpoint move them by percents and tens of
# positions.
METRICS_ONLY_RTOL = 1e-5
METRICS_ONLY_FLIPS = 2
# [17] plays this many warm and measured go9 moves at B=1024.
VISITS_WARM = 2
VISITS_STEPS = 2
# [18] runs the self-play bench in-process at (config, batch, timed moves)
# after one warm-up move: go19_jumbo at its full width and game length but
# 256 of its 2048 games (a B=2048 move takes ~57 s); then its CLI with
# BENCH_DP=2 at BENCH_DP_RUN.
JUMBO_BENCH = ("go19_jumbo", 256, 2)
BENCH_DP_RUN = ("go9", 256, 2)
EVAL_HEADER = ["datetime", "training_steps", "game_length", "game_result", "num_passes",
               "black_elo_rating", "white_elo_rating", "eval_games", "latest_win_rate",
               "value_mse_error", "policy_entropy", "policy_top_1_accuracy",
               "policy_top_3_accuracy", "policy_top_5_accuracy"]


def check_bench_lines(label, lines, metric, steps) -> None:
    """The bench's JSON lines as ``bench.py`` prints them: ``steps - 1``
    partial lines, then the result, every one of ``metric`` with a value
    above 0."""
    keys = ["metric", "value", "unit", "vs_baseline", "nn_sims_per_s", "budget_sims_per_s"]
    want = [keys + ["partial"]] * (steps - 1) + [keys]
    if [list(x) for x in lines] != want:
        raise SystemExit(f"{label} lines {lines}, expected {steps - 1} partial lines "
                         "and the result")
    if any(x["metric"] != metric or not x["value"] > 0 for x in lines):
        raise SystemExit(f"{label} lines {lines}, expected metric {metric} and values > 0")


def bench_run(label, card, name, batch, steps, dev) -> tuple:
    """The self-play bench (``tools/bench.py:run``) in-process: ``name`` at
    ``batch`` games with random weights of seed 0, one warm-up and
    ``steps`` timed moves, the launch counts set to 0 before it. Checks the
    lines as ``bench.py`` prints them, ``max_new_sims`` K1 and twice as
    many K2 launches in every move (the warm-up's too) and every timed
    move: legal on the games it was played on, ``search_pi`` rows summing
    to 1, ``root_visits`` within the budget, finite values. At Go, one K4
    (terminal scoring) launch an engine step: ``max_new_sims + 1`` a move.
    Returns the result, its numbers and the (K1, K2) launches of the
    run."""
    import torch

    from alpha_zero_tpu_torch.ops import scatter_kernels, score_kernels, tree_kernels
    from alpha_zero_tpu_torch.tools import bench

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    scorer = score_kernels.score_area
    b = bench.resolve(name, batch, steps=steps)
    select.launches = writer.launches = scorer.launches = 0
    t0 = time.time()
    result = bench.run(name, batch=batch, steps=steps, device=dev)
    wall = time.time() - t0
    launches = (select.launches, writer.launches)
    k4_per_move = b.loop_len + 1 if b.cfg.env.game == "go" else 0
    if scorer.launches != (1 + steps) * k4_per_move:
        raise SystemExit(f"{label} {scorer.launches} K4 launches in the run, expected "
                         f"{1 + steps} moves of {k4_per_move}")
    check_bench_lines(label, result.lines, b.metric, steps)
    per_move = (b.loop_len, 2 * b.loop_len)
    if result.launches != [[per_move] * steps]:
        raise SystemExit(f"{label} launches a timed move {result.launches}, expected "
                         f"{per_move}")
    if launches != tuple((1 + steps) * k for k in per_move):
        raise SystemExit(f"{label} {launches} launches in the run, expected {1 + steps} "
                         f"moves of {per_move}")
    for i, (out, legal) in enumerate(zip(result.moves, result.legal)):
        where = f"{label} timed move {i}"
        move = out.move.long()
        if not ((move >= 0) & (move < legal.shape[1])).all() or not bool(
                (legal.gather(1, move[:, None]) == 1).all()):
            raise SystemExit(f"{where}: an illegal move")
        if not torch.allclose(out.search_pi.sum(-1), torch.ones(batch), atol=1e-5):
            raise SystemExit(f"{where}: search_pi rows do not sum to 1")
        if not (out.root_visits <= b.sims).all():
            raise SystemExit(f"{where}: root_visits above the budget of {b.sims}")
        if not all(torch.isfinite(x).all() for x in (out.root_q, out.best_child_q)):
            raise SystemExit(f"{where}: non-finite values")
    values = [x["value"] for x in result.lines]
    out = {"batch": batch, "steps": steps, "env_steps_per_s": values[-1],
           "partial": values[:-1], "nn_sims_per_s": result.lines[-1]["nn_sims_per_s"],
           "peak_gib": result.peak_bytes[0] / 2**30, "wall_s": wall}
    print(f"{label} bench B={batch} on {card}: {values[-1]} env-steps/s over {steps} timed "
          f"moves after 1 warm-up (partial {values[:-1]}), {per_move[0]} K1, "
          f"{per_move[1]} K2 and {k4_per_move} K4 launches a move, peak "
          f"{out['peak_gib']:.2f} GiB; {wall:.1f} s",
          flush=True)
    return result, out, launches


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


def check_play_net(label, trainer) -> None:
    """The Trainer's bf16 self-play net equal to its float32 master weights
    cast to bf16, BatchNorm's tensors float32 and equal."""
    import torch

    master = trainer.train_state.net.state_dict()
    bn = {n for n, m in trainer.play_net.named_modules()
          if isinstance(m, torch.nn.BatchNorm2d)}
    for name, value in trainer.play_net.state_dict().items():
        want = (torch.float32 if name.rsplit(".", 1)[0] in bn else torch.bfloat16)
        if value.is_floating_point() and value.dtype != want:
            raise SystemExit(f"{label} self-play net's {name} is {value.dtype}, not {want}")
        if not torch.equal(value, master[name].to(value.dtype)):
            raise SystemExit(f"{label} self-play net != master weights cast to "
                             f"{value.dtype} after step {trainer.training_steps}: {name}")


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
        check_play_net("[8]", self)
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
    return out, ckpt_dir, cfg


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
    ``train.batch_size=1024``, 512 rows a rank), ``env.max_steps=GAME_STEPS``,
    one generation of 10 steps, ``--no-eval``, checked by ``parallel_run``
    (the first step's losses within ``DP_LOSS_ATOL``). Returns the numbers
    and each rank's (K1, K2) launches."""
    run_dir = os.path.join(HERE, "build", "chip_smoke_dp")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt_dir, logs_dir = os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "logs")
    sets = ["parallel.dp=2", f"parallel.selfplay_batch_size={BATCH}",
            f"train.batch_size={BATCH}", f"env.max_steps={GAME_STEPS}",
            f"train.min_games={BATCH}",
            f"train.games_per_ckpt={BATCH}", "train.ckpt_interval=10",
            "train.max_training_steps=10", f"run.ckpt_dir={ckpt_dir}",
            f"run.logs_dir={logs_dir}"]
    cfg, ranks, wall, check, _ = parallel_run("[10]", dev, sets, 10, BATCH, DP_LOSS_ATOL)
    r0 = ranks[0]
    if [x["games_a_step"] for x in ranks] != [BATCH // 2] * 2 or r0["world"] != 2:
        raise SystemExit(f"[10] games a rank {[x['games_a_step'] for x in ranks]}")
    out = {"config": "go9", "reduced": {"env.max_steps": GAME_STEPS, "training_steps": 10},
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
          f"env.max_steps={GAME_STEPS}); {len(r0['moves'])} self-play moves a rank "
          f"({loop_len} K1 and "
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


def fake_tkinter(plies: int = 0):
    """A recording stand-in for the ``tkinter`` module, to be placed in
    ``sys.modules`` before a ``BoardGameGui`` is made (the GUIs of both
    packages import tkinter inside ``__init__``). It replaces the display,
    never the device: the AI's moves run where the GUI's env and net are.

    Its widgets record every ``create_*``, ``delete`` and ``config`` call in
    ``calls`` as ``(method, args, kwargs)``; ``buttons`` maps each button's
    text to its command and ``bindings`` each bound event to its handler.
    ``Tk.after`` queues its callback (the GUI's ``play``). ``Tk.mainloop``
    runs the queue until the GUI's game has ``plies`` moves, or is over and
    announced, then returns; ``gui`` is then the GUI it ran.
    ``run_pending()`` runs the callbacks queued so far, once each."""
    import collections
    import types

    tk = types.ModuleType("tkinter")
    tk.LEFT = "left"
    tk.calls, tk.buttons, tk.bindings, tk.gui = [], {}, {}, None
    queue = collections.deque()

    class Widget:
        def __init__(self, master=None, **kw):
            if "command" in kw:
                tk.buttons[kw["text"]] = kw["command"]

        def pack(self, **kw):
            pass

        def config(self, **kw):
            tk.calls.append(("config", (), kw))

        def delete(self, *args):
            tk.calls.append(("delete", args, {}))

        def bind(self, event, handler):
            tk.bindings[event] = handler

        def __getattr__(self, name):
            if not name.startswith("create_"):
                raise AttributeError(name)
            return lambda *args, **kw: tk.calls.append((name, args, kw))

    class Tk(Widget):
        def title(self, text):
            pass

        def after(self, ms, callback):
            queue.append(callback)

        def mainloop(self):
            while queue:
                callback = queue.popleft()
                callback()
                tk.gui = callback.__self__
                env = tk.gui.env
                if env.steps >= plies or (env.is_game_over() and tk.gui.game_over_announced):
                    return

    def run_pending():
        for _ in range(len(queue)):
            queue.popleft()()

    tk.Tk, tk.Label, tk.Canvas, tk.Frame, tk.Button = Tk, Widget, Widget, Widget, Widget
    tk.run_pending = run_pending
    return tk


def check_gui_drawing(label, calls, boards, stone_r):
    """The recorded GUI calls after each ply: the canvas cleared and drawn
    again with one stone per stone of ``boards[k]`` (the board after ply
    k + 1; the first drawing is of the empty board), and the header of each
    step."""
    draws = [i for i, (name, args, _) in enumerate(calls) if name == "delete" and args == ("all",)]
    headers = [kw["text"] for name, _, kw in calls if name == "config"]
    if len(draws) != len(boards) + 1 or len(headers) != len(boards) + 1:
        raise SystemExit(f"{label}: {len(draws)} drawings and {len(headers)} headers for "
                         f"{len(boards)} plies")
    for k, start in enumerate(draws):
        end = draws[k + 1] if k + 1 < len(draws) else len(calls)
        stones = sum(1 for name, args, kw in calls[start:end]
                     if name == "create_oval" and args[2] - args[0] == 2 * stone_r)
        want = int((boards[k - 1] != 0).sum()) if k else 0
        if stones != want or f"to move (step {k})" not in headers[k]:
            raise SystemExit(f"{label}: drawing {k} has {stones} stones (board {want}), "
                             f"header {headers[k]!r}")


def searched_tree_kernels(label, tree, cfg, engine, dev):
    """K1 and K2 on a searched tree of ``cfg``'s search: K1 (the tree's
    next select) bit-equal to its plain version, K2 bit-equal to
    ``write_rows_plain`` on the materialize and expand sets with random rows
    for each lane's next slot and with every lane idle; then both timed
    (warm, L2-flushed and back to back, the plain version beside each, the
    bound from these inputs). Returns (k1, k2, the descents' depths)."""
    import torch

    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.tools import dma_probe, select_bench
    from alpha_zero_tpu_torch.utils.device import HBM_BYTES_PER_S, L2_BYTES, graph_ms, time_ms

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    b, t = tree.node_N.shape
    args = select_bench.select_args(tree)
    kw = dict(path_cap=min(cfg.search.num_simulations + 1, engine.max_steps + 2),
              c_puct_base=cfg.search.c_puct_base, c_puct_init=cfg.search.c_puct_init)
    got, ref = select(*args, **kw), tree_kernels.select_leaf_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, o, r in zip(select_bench.OUTPUTS, got, ref):
        if o.dtype != r.dtype or not torch.equal(o, r):
            raise SystemExit(f"{label} select kernel != plain on the searched tree: {name}")
    del got
    gen = torch.Generator(device=dev).manual_seed(13)
    widx = torch.where(tree.num_nodes < t, tree.num_nodes, -1.0).to(torch.int32)
    arrays = mcts.materialize_arrays(tree)
    rows = [torch.randint(-100, 100, (b,) + a.shape[2:], generator=gen,
                          device=dev).to(a.dtype) for a in arrays]
    expand = ([tree.child_P, tree.node_expanded],
              [torch.rand((b,) + tree.child_P.shape[2:], generator=gen, device=dev),
               torch.ones(b, dtype=torch.bool, device=dev)])
    for arr, rr in ((arrays, rows), expand):
        for w in (widx, torch.full_like(widx, -1)):
            dma_probe.check_writer(writer, arr, rr, w)
    k1 = select_bench.time_select(select, args, kw, 50)
    k1["plain_ms"] = time_ms(lambda: tree_kernels.select_leaf_plain(*args, **kw), 5)
    k1.update(select_bench.select_bound(ref[6], b, t, tree.child_P.shape[2]))

    def write():
        writer(arrays, rows, widx)

    k2 = dict(ms=graph_ms(write, 50), cold_ms=graph_ms(write, 50, 2 * L2_BYTES),
              back_to_back_ms=time_ms(write, 50),
              plain_ms=graph_ms(lambda: scatter_kernels.write_rows_plain(arrays, rows, widx), 50),
              bytes=dma_probe.set_bytes(b, rows))
    k2.update(bound_ms=k2["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return k1, k2, ref[6]


def gui_path(card, dev) -> dict:
    """[13]: ``cli.analysis`` through its ``main`` (``params`` on the card
    against the CPU's counts, ``score-demo`` on the card bit-equal to the
    CPU, ``puct``), then ``cli.play.main(["--config", "go19_jumbo",
    "--ai_vs_ai", ...])`` under ``fake_tkinter`` for ``GUI_PLIES`` plies at
    full width (19 x 256 bf16 net of seed 0, 800 simulations on fresh
    trees, T=801, A=362, B=1): 799 K1 and 1,598 K2 launches a ply, every
    move accepted by the host ``GoEnv`` and replayed to the same board by a
    fresh one on the CPU, the board and header drawn after each ply; then
    K1 and K2 on the last ply's searched tree, bit-equal to their plain
    versions and timed. Returns the numbers and the GUI run's (K1, K2)
    launches."""
    import contextlib
    import io

    import torch

    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.cli import analysis
    from alpha_zero_tpu_torch.cli import play as cli_play
    from alpha_zero_tpu_torch.cli.gui import STONE_R
    from alpha_zero_tpu_torch.envs.host import GoEnv
    from alpha_zero_tpu_torch.eval import evaluator as evaluator_lib
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.training.pipeline import build_engine

    def analysis_out(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            analysis.main(list(argv))
        return out.getvalue()

    # cli.analysis: the commands that need neither pandas nor matplotlib.
    t0 = time.time()
    params = analysis_out("params", "--device", str(dev))
    names = [line.split()[0] for line in params.splitlines()]
    if names != sorted(config_lib.CONFIGS) or params != analysis_out("params", "--device", "cpu"):
        raise SystemExit(f"[13] analysis params on the card != CPU:\n{params}")
    areas = analysis.score_demo_areas(dev)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(areas, analysis.score_demo_areas("cpu"))):
        raise SystemExit("[13] score-demo areas on the card != CPU")
    demo = analysis_out("score-demo", "--device", str(dev))
    if demo != analysis_out("score-demo", "--device", "cpu") or demo.count("computed") != 7:
        raise SystemExit(f"[13] score-demo on the card != CPU:\n{demo}")
    puct = analysis_out("puct")
    if len(puct.splitlines()) != 9:
        raise SystemExit(f"[13] analysis puct:\n{puct}")
    analysis_s = time.time() - t0
    print(f"[13] cli.analysis on {card}: params ({analysis_s:.1f} s for the three commands) "
          f"== CPU:\n{params.rstrip()}", flush=True)
    print(f"[13] score-demo areas on the card bit-equal to the CPU "
          f"(black {areas[0].tolist()}, white {areas[1].tolist()}); puct printed", flush=True)

    # The GUI's AI-vs-AI game at go19_jumbo full width, on the card.
    cfg = config_lib.go19_jumbo()
    sims = cfg.search.num_simulations
    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    plies, trees = [], []
    make_move_fn, search = evaluator_lib.make_eval_move_fn, mcts.batched_search

    def keep_tree(*args, **kwargs):
        result, tree = search(*args, return_trees=True, **kwargs)
        trees[:] = [tree]
        return result

    tk = fake_tkinter(GUI_PLIES)
    saved_tk = sys.modules.get("tkinter")
    evaluator_lib.make_eval_move_fn = lambda *a, **k: counting(make_move_fn(*a, **k), plies)
    mcts.batched_search = keep_tree
    sys.modules["tkinter"] = tk
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k0 = (select.launches, writer.launches)
    t0 = time.time()
    try:
        cli_play.main(["--config", "go19_jumbo", "--ai_vs_ai", "--device", str(dev)])
    finally:
        evaluator_lib.make_eval_move_fn, mcts.batched_search = make_move_fn, search
        if saved_tk is None:
            del sys.modules["tkinter"]
        else:
            sys.modules["tkinter"] = saved_tk
    gui_s = time.time() - t0
    launches = (select.launches - k0[0], writer.launches - k0[1])
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    check_plies("[13] go19_jumbo GUI", plies, sims)
    env = tk.gui.env
    if len(plies) != GUI_PLIES or env.steps != GUI_PLIES or env.is_game_over():
        raise SystemExit(f"[13] the GUI played {len(plies)} plies, env at step {env.steps}")
    replay = GoEnv(board_size=19, komi=cfg.env.komi, num_stack=cfg.env.num_stack, device="cpu")
    boards = []
    for color, move in env.history:
        if not replay.is_legal_move(move):
            raise SystemExit(f"[13] move {color} {move} illegal on a CPU replay")
        replay.step(move)
        boards.append(replay.board.copy())
    if not (replay.board == env.board).all():
        raise SystemExit("[13] the CPU replay's board != the GUI's")
    check_gui_drawing("[13] go19_jumbo GUI", tk.calls, boards, STONE_R)

    # K1 and K2 on the last ply's searched tree (B=1, T=801, A=362).
    (tree,) = trees
    k1, k2, depth = searched_tree_kernels("[13]", tree, cfg, build_engine(cfg.env), dev)
    t = tree.node_N.shape[1]

    out = {"config": "go19_jumbo", "reduced": None, "plies": len(plies),
           "ply_s": [s for _, _, s in plies], "gui_s": gui_s, "analysis_s": analysis_s,
           "peak_gib": peak, "held_before_gib": held / 2**30,
           "moves": [list(m) for m in env.history],
           "tree_nodes": int(tree.num_nodes[0]), "depth_max": int(depth.max()),
           "k1": k1, "k2": k2}
    print(f"[13] go19_jumbo cli.play --ai_vs_ai (19 x 256, bf16, 800 sims, fresh trees "
          f"T={t} A={tree.child_P.shape[2]}, B=1; tkinter stand-in) on {card}: {len(plies)} "
          f"plies of {', '.join(f'{s:.2f}' for s in out['ply_s'])} s ({sims - 1} K1 and "
          f"{2 * (sims - 1)} K2 launches each), {gui_s:.1f} s with the net's build; moves "
          f"{out['moves']} legal, replayed on the CPU to the same board; board and header "
          f"drawn after each ply; peak memory {peak:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before it", flush=True)
    print(f"[13] K1 and K2 bit-equal to their plain versions on the searched go19_jumbo "
          f"tree ({out['tree_nodes']} nodes, depth max {out['depth_max']}). K1 graph "
          f"{k1['ms'] * 1e3:.2f} us warm, {k1['cold_ms'] * 1e3:.2f} us cold, back to back "
          f"{k1['back_to_back_ms'] * 1e3:.2f} us, plain {k1['plain_ms']:.4f} ms, bound "
          f"{k1['bound_ms'] * 1e3:.3f} us ({k1['bound_by']}); K2 materialize set "
          f"{k2['ms'] * 1e3:.2f} us warm, {k2['cold_ms'] * 1e3:.2f} us cold, plain "
          f"{k2['plain_ms'] * 1e3:.2f} us, bound {k2['bound_ms'] * 1e3:.4f} us, on {card}",
          flush=True)
    print("[13] " + json.dumps(out), flush=True)
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
    # positions 6 random moves into games of 8 moves (GAME_STEPS until [18]
    # was added; a 6-move game is over there), so that the times compare
    # with earlier runs'.
    engine = build_engine(dataclasses.replace(cfg.env, max_steps=8))
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


def kept_bn_forward(self, x):
    """The train-mode BatchNorm forward that ``models/resnet.py``'s
    recompute (``_TrainBatchNorm``) replaced, on one model group: the same
    float32 ops with autograd keeping their intermediates, two float32
    copies of every activation. [14] holds the recompute to it."""
    import torch

    if not self.training:
        return torch.nn.BatchNorm2d.forward(self, x)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
    return y.to(x.dtype)


def bn_recompute_check(cfg, dev, states, pis, values) -> dict:
    """One forward and backward of ``cfg``'s net in train mode (bf16
    autocast, float32 master weights of seed 0, ``learner.loss_fn``) on the
    given rows, with the recompute BatchNorm and with ``kept_bn_forward``,
    cuDNN deterministic: the losses, every gradient and every running
    statistic must be bit-equal. Returns each one's peak memory above what
    was held before it, in GiB."""
    import copy

    import torch

    from alpha_zero_tpu_torch.models.resnet import BatchNorm, build_network
    from alpha_zero_tpu_torch.training import learner

    net = build_network(cfg.env, cfg.network, device=dev, seed=0, dtype="float32").train()
    nets = {"recompute": net, "kept": copy.deepcopy(net)}
    results, peaks = {}, {}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    recompute_forward = BatchNorm.forward
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for name, n in nets.items():
            BatchNorm.forward = kept_bn_forward if name == "kept" else recompute_forward
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            losses = learner.loss_fn(n, states, pis, values, torch.bfloat16)
            sum(losses).backward()
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - held) / 2**30
            results[name] = [x.detach() for x in losses] + [p.grad for p in n.parameters()] + [
                b for b in n.buffers()]
    finally:
        BatchNorm.forward = recompute_forward
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for i, (a, b) in enumerate(zip(results["recompute"], results["kept"])):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise SystemExit(f"[14] recompute BatchNorm != the kept formulation: tensor {i} "
                             f"of losses, gradients and buffers")
    return peaks


def replay_on_cpu(label, cfg, outputs) -> None:
    """The self-play moves ``outputs`` (each move's ``move``, ``done`` and
    ``final_score`` for every lane, on the host) replayed in lockstep by the
    engine on the CPU from empty boards, finished games reset as self-play
    resets them: every move legal, every game ending on the same move with
    the same score."""
    import torch

    from alpha_zero_tpu_torch.training.pipeline import build_engine

    engine = build_engine(cfg.env)
    batch = outputs[0]["move"].shape[0]
    games = engine.init_batch(batch, device="cpu")
    for i, out in enumerate(outputs):
        move = out["move"].long()
        if not (games.legal.gather(1, move[:, None]) == 1.0).all():
            raise SystemExit(f"{label} move {i + 1} illegal on a CPU replay")
        games = engine.step_batch(games, move.to(torch.int32))
        if not torch.equal(games.done, out["done"]):
            raise SystemExit(f"{label} move {i + 1}: games end on other moves on the CPU")
        if not torch.equal(games.final_score[games.done], out["final_score"][games.done]):
            raise SystemExit(f"{label} move {i + 1}: final scores differ on the CPU")
        done = games.done
        games = engine.init_batch(batch, device="cpu").map2(games, lambda f, g: torch.where(
            done.reshape((batch,) + (1,) * (g.dim() - 1)), f, g))


def jumbo_path(card, dev) -> dict:
    """[14]: ``cli.train.main(["--config", "go19_jumbo", "--no-eval", ...])``
    in-process at go19_jumbo's own widths (B=2048 self-play games, 19 x 256
    bf16 net, 800 simulations with ``max_new_sims=480`` on trees of T=801,
    A=362, train batch 2048), cut only in length: ``env.max_steps=2``, one
    generation of 2048 games and 2 train steps. Checks every move's K1 and
    K2 launches, every move legal on a CPU replay, ``search_pi`` rows
    summing to 1, the replay, finite losses, the checkpoint restored
    bit-equal, the self-play net equal to the master weights; times the
    moves and (after the run, the trees still resident) the train step;
    holds the recompute BatchNorm to the formulation it replaced at batch
    ``BN_CHECK_BATCH``; then K1 and K2 on the searched tree of move 2,
    bit-equal to their plain versions on all lanes and timed. Returns the
    numbers and the run's (K1, K2) launches."""
    import copy
    import csv
    import math

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from alpha_zero_tpu_torch.cli import train as cli_train
    from alpha_zero_tpu_torch.cli.common import resolve_config
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
    from alpha_zero_tpu_torch.training import learner
    from alpha_zero_tpu_torch.training.pipeline import build_engine
    from alpha_zero_tpu_torch.utils.device import BF16_OPS_PER_S

    run_dir = os.path.join(HERE, "build", "chip_smoke_jumbo")
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt_dir, logs_dir = os.path.join(run_dir, "ckpt"), os.path.join(run_dir, "logs")
    widths = resolve_config("go19_jumbo", [])
    batch, train_batch = widths.parallel.selfplay_batch_size, widths.train.batch_size
    sets = [f"env.max_steps={JUMBO_GAME_STEPS}", f"train.min_games={batch}",
            f"train.games_per_ckpt={batch}", f"train.max_training_steps={JUMBO_TRAIN_STEPS}",
            f"train.ckpt_interval={JUMBO_TRAIN_STEPS}", f"run.ckpt_dir={ckpt_dir}",
            f"run.logs_dir={logs_dir}"]
    argv = ["--config", "go19_jumbo", "--device", str(dev), "--no-eval"] + [
        x for v in sets for x in ("--set", v)]
    cfg = resolve_config("go19_jumbo", sets)
    loop_len = cfg.search.max_new_sims  # batched_search's loop, fresh or reused tree

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    seen = {"moves": [], "move_peaks": [], "outputs": [], "steps": [], "trainer": None,
            "tree": None}

    def prepare(trainer):
        """Instruments the Trainer ``cli.train`` built, before it runs."""
        seen["trainer"] = trainer
        step = trainer.selfplay_step
        train_once, generation = trainer._train_once, trainer.train_generation

        def counted_step(*args, **kwargs):
            s0, w0 = select.launches, writer.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sp, out = step(*args, **kwargs)
            torch.cuda.synchronize()
            seen["moves"].append((select.launches - s0, writer.launches - w0,
                                  time.perf_counter() - t0))
            seen["move_peaks"].append(torch.cuda.max_memory_allocated() / 2**30)
            seen["outputs"].append({"move": out.move.cpu(), "done": out.done.cpu(),
                                    "final_score": out.final_score.cpu(),
                                    "pi_sum": out.search_pi.sum(-1).cpu()})
            return sp, out

        def timed_train_once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_once()
            torch.cuda.synchronize()
            seen["steps"].append((float(metrics.policy_loss), float(metrics.value_loss),
                                  time.perf_counter() - t0))
            return metrics

        def measured_generation():
            torch.cuda.reset_peak_memory_stats()
            seen["held_before_train"] = torch.cuda.memory_allocated() / 2**30
            generation()
            seen["train_peak"] = torch.cuda.max_memory_allocated() / 2**30

        trainer.selfplay_step = counted_step
        trainer._train_once, trainer.train_generation = timed_train_once, measured_generation

    search = mcts.batched_search

    def keep_tree(*args, **kwargs):
        result = search(*args, **kwargs)
        if len(seen["moves"]) == 1:  # the search of move 2, on rerooted trees
            seen["tree"] = result[1]
        return result

    k0 = (select.launches, writer.launches)
    mcts.batched_search = keep_tree
    t0 = time.time()
    try:
        cli_train.main(argv, prepare=prepare)
    finally:
        mcts.batched_search = search
    wall = time.time() - t0
    launches = (select.launches - k0[0], writer.launches - k0[1])
    trainer, tree = seen["trainer"], seen["tree"]
    if trainer is None or trainer.training_steps != JUMBO_TRAIN_STEPS or tree is None:
        raise SystemExit("[14] the run did not reach its step budget")
    per_move = sorted({(k1, k2) for k1, k2, _ in seen["moves"]})
    if per_move != [(loop_len, 2 * loop_len)]:
        raise SystemExit(f"[14] launches per self-play move {per_move}, expected "
                         f"({loop_len}, {2 * loop_len})")
    if launches != (loop_len * len(seen["moves"]), 2 * loop_len * len(seen["moves"])):
        raise SystemExit(f"[14] {launches} K1/K2 launches in the run, not the moves' sum")
    b, t, a = tree.child_P.shape
    if (b, t, a) != (batch, cfg.search.num_simulations + 1, cfg.env.num_actions):
        raise SystemExit(f"[14] searched trees of shape {(b, t, a)}")

    # Every move legal and every game scored alike on a CPU replay; the
    # search policy, the replay and the losses.
    t1 = time.time()
    replay_on_cpu("[14]", cfg, seen["outputs"])
    replay_s = time.time() - t1
    for i, out in enumerate(seen["outputs"]):
        if not torch.allclose(out["pi_sum"], torch.ones(batch), atol=1e-5):
            raise SystemExit(f"[14] move {i + 1}: search_pi rows do not sum to 1")
    games = sum(int(out["done"].sum()) for out in seen["outputs"])
    replay = trainer.replay
    if not (replay.num_games_added == games >= batch
            and replay.size == replay.num_samples_added == JUMBO_GAME_STEPS * games):
        raise SystemExit(f"[14] replay holds {replay.num_games_added} games and "
                         f"{replay.size} samples; {games} games finished")
    n = replay.size
    if not np.allclose(replay.pi_probs[:n].sum(-1), 1.0, atol=1e-5):
        raise SystemExit("[14] replay pi rows do not sum to 1")
    losses = [(pl, vl) for pl, vl, _ in seen["steps"]]
    if len(losses) != JUMBO_TRAIN_STEPS or not all(math.isfinite(x) for p in losses for x in p):
        raise SystemExit(f"[14] train steps' losses {losses}")
    with open(os.path.join(logs_dir, "training.csv")) as f:
        rows = list(csv.DictReader(f))
    if int(rows[-1]["training_steps"]) != JUMBO_TRAIN_STEPS:
        raise SystemExit(f"[14] training.csv rows {rows}")

    # The checkpoint, restored into a fresh state, and the self-play net.
    fresh = learner.create_train_state(
        build_network(cfg.env, cfg.network, device=dev, dtype="float32"), cfg.train)
    path = os.path.join(ckpt_dir, f"training_steps_{JUMBO_TRAIN_STEPS}")
    t1 = time.time()
    restored = ckpt_lib.restore_checkpoint(path, fresh)
    restore_s = time.time() - t1
    if not ckpt_lib.states_equal(restored, trainer.train_state):
        raise SystemExit(f"[14] {path} restores a different state")
    del fresh, restored
    check_play_net("[14]", trainer)

    # ms a train step at batch 2048 (CUDA events, warm) with the self-play
    # trees still resident; the warm-up step counts its operations.
    step = learner.make_train_step(cfg.network.inference_dtype, cfg.train.argument_data)
    sample = replay.sample(train_batch)
    inputs = tuple(torch.from_numpy(x).to(dev) for x in (sample.state, sample.pi_prob,
                                                        sample.value))
    timing_state = copy.deepcopy(trainer.train_state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    with FlopCounterMode(display=False) as flops:
        step(timing_state, *inputs, 0)
    step_ms = []
    for tid in (3, 5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(timing_state, *inputs, tid)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    timed_peak = torch.cuda.max_memory_allocated() / 2**30
    step_flops = flops.get_total_flops()
    bound_ms = step_flops / BF16_OPS_PER_S * 1e3
    del timing_state

    # The recompute BatchNorm against the formulation it replaced, at
    # go19_jumbo width on the first BN_CHECK_BATCH of those rows.
    rows_bn = tuple(x[:BN_CHECK_BATCH] for x in inputs)
    del inputs
    t1 = time.time()
    bn_peaks = bn_recompute_check(cfg, dev, *rows_bn)
    bn_s = time.time() - t1

    # K1 and K2 on the searched tree of move 2 (B=2048, T=801, A=362).
    seen["tree"] = None
    k1, k2, depth = searched_tree_kernels("[14]", tree, cfg, build_engine(cfg.env), dev)
    del tree
    shutil.rmtree(ckpt_dir)  # ~0.2 GB; the CSVs stay

    move_s = [s for _, _, s in seen["moves"]]
    out = {"config": "go19_jumbo",
           "reduced": {"env.max_steps": JUMBO_GAME_STEPS, "games": batch,
                       "training_steps": JUMBO_TRAIN_STEPS},
           "selfplay_batch": batch, "train_batch": train_batch, "tree": [b, t, a],
           "selfplay_moves": len(move_s), "move_s": move_s,
           "env_steps_per_s": batch * len(move_s) / sum(move_s),
           "launches_a_move": [loop_len, 2 * loop_len], "games": games, "samples": n,
           "losses": losses, "run_step_s": [s for _, _, s in seen["steps"]],
           "train_step_ms": step_ms, "train_samples_per_s": train_batch * 1e3 / min(step_ms),
           "train_step_flops": step_flops, "train_step_bound_ms": bound_ms,
           "move_peak_gib": seen["move_peaks"],
           "held_before_train_gib": seen["held_before_train"],
           "train_peak_gib": seen["train_peak"], "timed_train_held_gib": held,
           "timed_train_peak_gib": timed_peak, "card_gib": torch.cuda.get_device_properties(
               dev).total_memory / 2**30,
           "bn_check_batch": BN_CHECK_BATCH, "bn_peak_gib": bn_peaks, "bn_check_s": bn_s,
           "replay_s": replay_s, "restore_s": restore_s, "wall_s": wall,
           "depth_mean": float(depth.double().mean()), "depth_max": int(depth.max()),
           "k1": k1, "k2": k2}
    if max(seen["move_peaks"] + [seen["train_peak"], timed_peak]) >= out["card_gib"]:
        raise SystemExit(f"[14] peak memory past the card's {out['card_gib']:.1f} GiB")
    print(f"[14] go19_jumbo via cli.train --no-eval (19 x 256 bf16, 800 sims max_new_sims="
          f"{loop_len}, B={batch}, T={t}, A={a}; train batch {train_batch}; "
          f"env.max_steps={JUMBO_GAME_STEPS} and {JUMBO_TRAIN_STEPS} steps the only cuts) on "
          f"{card}: {len(move_s)} self-play moves of "
          + ", ".join(f"{x:.2f}" for x in move_s)
          + f" s ({loop_len} K1 and {2 * loop_len} K2 launches each; "
          f"{out['env_steps_per_s']:.1f} env-steps/s), {games} games legal on a CPU replay "
          f"({replay_s:.1f} s), {n} samples; train steps in the run "
          + ", ".join(f"{x:.2f}" for x in out["run_step_s"]) + f" s, losses {losses}; "
          f"{wall:.1f} s in cli.train", flush=True)
    print(f"[14] train step at batch {train_batch}, warm, trees resident: "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f" ms ({out['train_samples_per_s']:.0f} samples/s; bound {bound_ms:.2f} ms: "
          f"{step_flops / 1e12:.2f} TFLOP at the bf16 peak). Peak memory a self-play move "
          + ", ".join(f"{x:.2f}" for x in seen["move_peaks"])
          + f" GiB (from move 3 on, with move 2's tree kept here), the run's train steps "
          f"{seen['train_peak']:.2f} GiB ({seen['held_before_train']:.2f} held before, that "
          f"tree among it), the timed steps {timed_peak:.2f} GiB ({held:.2f} held), of "
          f"{out['card_gib']:.1f}; checkpoint "
          f"restored bit-equal ({restore_s:.1f} s); self-play net == master weights", flush=True)
    print(f"[14] recompute BatchNorm bit-equal to the kept formulation at batch "
          f"{BN_CHECK_BATCH} (losses, every gradient and running statistic; cuDNN "
          f"deterministic): peak above held {bn_peaks['recompute']:.2f} GiB against "
          f"{bn_peaks['kept']:.2f} GiB ({bn_s:.1f} s)", flush=True)
    print(f"[14] K1 and K2 bit-equal to their plain versions on all {b} lanes of move 2's "
          f"searched tree (depth mean {out['depth_mean']:.2f}, max {out['depth_max']}). K1 "
          f"graph {k1['ms'] * 1e3:.2f} us warm, {k1['cold_ms'] * 1e3:.2f} us cold, back to "
          f"back {k1['back_to_back_ms'] * 1e3:.2f} us, plain {k1['plain_ms']:.4f} ms, bound "
          f"{k1['bound_ms'] * 1e3:.3f} us ({k1['bound_by']}); K2 materialize set "
          f"{k2['ms'] * 1e3:.2f} us warm, {k2['cold_ms'] * 1e3:.2f} us cold, back to back "
          f"{k2['back_to_back_ms'] * 1e3:.2f} us, plain (put_rows x13) "
          f"{k2['plain_ms'] * 1e3:.2f} us, bound {k2['bound_ms'] * 1e3:.3f} us, on {card}",
          flush=True)
    print("[14] " + json.dumps(out), flush=True)
    seen.clear()
    return out, launches


def sweep_path(card, dev) -> dict:
    """[15]: the engine parity sweep (``tools/device_parity.py:sweep``) on
    the card at each board of ``SWEEPS``: identical random games (the JAX
    tool's moves) through ``step_batch`` on the card and on the CPU, every
    field after every step. Returns each board's results and seconds."""
    from alpha_zero_tpu_torch.tools import device_parity

    out = {}
    for game, n, batches, steps in SWEEPS:
        label = f"{game} {n}x{n}"
        t0 = time.time()
        results = device_parity.sweep(game, n, batches, steps, dev)
        secs = time.time() - t0
        for r in results:
            print(f"[15] {label} {device_parity.result_line(r)}", flush=True)
        if not all(r["ok"] for r in results):
            raise SystemExit(f"[15] {label}: the engine on the card diverged from the CPU")
        captures = [r["captures"] for r in results]
        if game == "go" and not sum(captures):
            raise SystemExit(f"[15] {label}: no capture in {steps} steps")
        print(f"[15] {label}: captured stones {captures}, ko points "
              f"{[r['ko'] for r in results]}, finished games {[r['done'] for r in results]} "
              f"at B={list(batches)} after {steps} steps; {secs:.1f} s on {card}", flush=True)
        out[label] = {"seconds": secs, "results": results}
    print("[15] " + json.dumps(out), flush=True)
    return out


def score_path(card, dev) -> dict:
    """[15], then: K4 against the plain scoring (``area_counts_plain``) on
    the card at each of ``SCORE_CHECKS``, every lane bit-equal with and
    without a mask, and the times of both. Returns each board's numbers."""
    import torch

    from alpha_zero_tpu_torch.envs.go import GoEngine
    from alpha_zero_tpu_torch.ops import score_kernels
    from alpha_zero_tpu_torch.tools.score_boards import (played_boards, score_mismatches,
                                                         snake_boards)
    from alpha_zero_tpu_torch.utils.device import HBM_BYTES_PER_S, graph_ms, time_ms

    out = {}
    for n, batch, plies in SCORE_CHECKS:
        t0 = time.time()
        label = f"go{n} B={batch}"
        engine = GoEngine(board_size=n)
        snakes = snake_boards(n).to(dev)
        boards = torch.cat([played_boards(engine, batch - len(snakes), plies, n, dev), snakes])
        gen = torch.Generator(device=dev).manual_seed(n)
        mask = torch.rand(batch, generator=gen, device=dev) < SCORE_MASKED
        bad = score_mismatches(engine, boards, mask)
        if any(bad.values()):
            raise SystemExit(f"[15] K4 {label}: lanes unlike the plain scoring {bad}")
        scored = int(mask.sum())
        # Board bytes of the lanes scored, a mask byte a lane, 12 bytes out a lane.
        bound = {m: (lanes * n * n + extra * batch + 12 * batch) / HBM_BYTES_PER_S * 1e3
                 for m, lanes, extra in (("all", batch, 0), ("masked", scored, 1))}
        r = {"batch": batch, "masked_lanes": scored,
             "ms": graph_ms(lambda: score_kernels.score_area(engine, boards), 50),
             "masked_ms": graph_ms(lambda: score_kernels.score_area(engine, boards, mask), 50),
             "bound_ms": bound["all"], "masked_bound_ms": bound["masked"],
             "plain_ms": time_ms(lambda: engine.area_counts_plain(boards), 3)}
        print(f"[15] K4 {label} ({len(snakes)} snake boards): bit-equal to the plain "
              f"scoring on every lane, with and without a mask of {scored} lanes; "
              f"{r['ms'] * 1e3:.2f} us a call (bound {r['bound_ms'] * 1e3:.3f} us), masked "
              f"{r['masked_ms'] * 1e3:.2f} us (bound {r['masked_bound_ms'] * 1e3:.3f} us); "
              f"plain {r['plain_ms']:.2f} ms; {time.time() - t0:.1f} s, on {card}", flush=True)
        out[f"go{n}"] = r
    return out


def backfill_path(card, dev, cfg, ckpt_dir, train) -> tuple:
    """[16]: ``tools/backfill_eval.py:backfill`` on [8]'s checkpoints with
    [8]'s resolved config (``eval_games=2``, the pro games of
    ``logs/go/9x9_matched/sgf``). Its rows must equal [8]'s in-run
    ``evaluation.csv`` in every column but ``datetime``, every ply a
    fresh-tree search of 199 K1 and 398 K2 launches, the run's dataset cache
    reused; then a ``metrics_only`` pass, whose batch of 8192 is held to the
    rows' pro metrics within ``METRICS_ONLY_RTOL`` and
    ``METRICS_ONLY_FLIPS``. Returns the numbers and the backfill's (K1, K2)
    launches."""
    import csv

    from alpha_zero_tpu_torch.eval import match as match_lib
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
    from alpha_zero_tpu_torch.tools import backfill_eval

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    eval_rows, positions = train["evaluation_rows"], train["eval_dataset_positions"]
    run_dir = os.path.dirname(ckpt_dir)
    n = cfg.env.board_size
    cache = os.path.join(ckpt_dir, f"eval_dataset_{n}x{n}.npz")
    if not os.path.exists(cache):
        raise SystemExit(f"[16] [8] left no dataset cache {cache}")
    cache_mtime = os.stat(cache).st_mtime_ns

    def read(path):
        with open(path) as f:
            header, *rows = csv.reader(f)
        return header, [dict(zip(header, row)) for row in rows]

    plies = []
    make_match = match_lib.make_match_move_fn
    match_lib.make_match_move_fn = lambda *a, **k: counting(make_match(*a, **k), plies)
    rows_csv = os.path.join(run_dir, "evaluation_backfill.csv")
    k0 = (select.launches, writer.launches)
    t0 = time.time()
    try:
        rc = backfill_eval.backfill(cfg, ckpt_dir, rows_csv, cfg.run.eval_games_dir,
                                    eval_games=cfg.run.eval_games, device=dev)
    finally:
        match_lib.make_match_move_fn = make_match
    backfill_s = time.time() - t0
    launches = (select.launches - k0[0], writer.launches - k0[1])
    if rc != 0:
        raise SystemExit(f"[16] backfill returned {rc}")
    check_plies("[16] backfill", plies, cfg.search.num_simulations)
    if os.stat(cache).st_mtime_ns != cache_mtime:
        raise SystemExit("[16] the backfill rebuilt the run's dataset cache")
    header, rows = read(rows_csv)
    if header != EVAL_HEADER:
        raise SystemExit(f"[16] backfill header {header}")
    if len(rows) != len(eval_rows):
        raise SystemExit(f"[16] {len(rows)} backfill rows, {len(eval_rows)} in-run rows")
    for row, ref in zip(rows, eval_rows):
        diff = [k for k in EVAL_HEADER[1:] if row[k] != ref[k]]
        if diff:
            raise SystemExit(f"[16] the backfill's row for step {ref['training_steps']} != "
                             f"the run's in {diff}: "
                             + "; ".join(f"{k} {row[k]} vs {ref[k]}" for k in diff))

    metrics_csv = os.path.join(run_dir, "evaluation_backfill_metrics.csv")
    t0 = time.time()
    rc = backfill_eval.backfill(cfg, ckpt_dir, metrics_csv, cfg.run.eval_games_dir,
                                metrics_only=True, device=dev)
    metrics_s = time.time() - t0
    header, metric_rows = read(metrics_csv)
    if rc != 0 or header != ["datetime", "training_steps"] + EVAL_HEADER[9:]:
        raise SystemExit(f"[16] metrics-only pass returned {rc}, header {header}")
    worst = {"rel": 0.0, "flips": 0}
    for row, ref in zip(metric_rows, eval_rows, strict=True):
        if row["training_steps"] != ref["training_steps"]:
            raise SystemExit(f"[16] metrics-only rows for steps {row['training_steps']}")
        for k in EVAL_HEADER[9:11]:
            rel = abs(float(row[k]) - float(ref[k])) / abs(float(ref[k]))
            worst["rel"] = max(worst["rel"], rel)
        for k in EVAL_HEADER[11:]:
            flips = round(abs(float(row[k]) - float(ref[k])) * positions)
            worst["flips"] = max(worst["flips"], flips)
    print(f"[16] metrics-only pass (batch {backfill_eval.METRICS_BATCH}) against the run's "
          f"rows (batch 1024): value error and entropy within {worst['rel']:.3e} relative, "
          f"top-k hits apart by at most {worst['flips']} of {positions} positions", flush=True)
    if worst["rel"] > METRICS_ONLY_RTOL or worst["flips"] > METRICS_ONLY_FLIPS:
        raise SystemExit(f"[16] metrics-only pass off the run's rows past "
                         f"{METRICS_ONLY_RTOL} relative or {METRICS_ONLY_FLIPS} hits")
    out = {"config": "go9", "reduced": {"env.max_steps": GAME_STEPS}, "rows": len(rows),
           "backfill_s": backfill_s, "plies": len(plies),
           "ply_s": sum(s for _, _, s in plies) / len(plies), "launches": launches,
           "metrics_only_s": metrics_s, "metrics_only_worst": worst,
           "positions": positions}
    print(f"[16] backfill of [8]'s {len(rows)} checkpoints on {card} (eval_games="
          f"{cfg.run.eval_games}, pro metrics over {positions} positions from the run's "
          f"cached dataset): every column but datetime equal to the run's evaluation.csv; "
          f"{len(plies)} plies of {cfg.search.num_simulations - 1} K1 and "
          f"{2 * (cfg.search.num_simulations - 1)} K2 launches; {backfill_s:.1f} s "
          f"({out['ply_s']:.3f} s a ply); metrics-only pass {metrics_s:.1f} s", flush=True)
    print("[16] " + json.dumps(out), flush=True)
    return out, launches


def visits_path(card, dev) -> tuple:
    """[17]: ``tools/visits_hist.py`` at go9 (200 simulations, reuse,
    ``max_new_sims=120``, random weights of seed 0 in bf16), B=1024,
    ``VISITS_WARM`` warm and ``VISITS_STEPS`` measured moves: 120 K1 and
    240 K2 launches every move, every N_root in [1, 200], the histogram's
    shares summing to 1; prints the report. Returns the numbers and the
    (K1, K2) launches."""
    import numpy as np

    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.tools import visits_hist
    from alpha_zero_tpu_torch.training import selfplay

    cfg = visits_hist.with_reuse(config_lib.go9())
    sims, loop_len = cfg.search.num_simulations, cfg.search.max_new_sims
    moves = []
    make_step = selfplay.make_selfplay_step
    selfplay.make_selfplay_step = lambda *a, **k: counting(make_step(*a, **k), moves)
    t0 = time.time()
    try:
        v = visits_hist.root_visits(cfg, BATCH, VISITS_WARM, VISITS_STEPS, dev)
    finally:
        selfplay.make_selfplay_step = make_step
    wall = time.time() - t0
    counts = [(k1, k2) for k1, k2, _ in moves]
    if counts != [(loop_len, 2 * loop_len)] * (VISITS_WARM + VISITS_STEPS):
        raise SystemExit(f"[17] launches per move {counts}, expected "
                         f"{VISITS_WARM + VISITS_STEPS} x ({loop_len}, {2 * loop_len})")
    if v.shape != (BATCH * VISITS_STEPS,) or not (1 <= v.min() and v.max() <= sims):
        raise SystemExit(f"[17] N_root of shape {v.shape} in [{v.min()}, {v.max()}], "
                         f"expected {BATCH * VISITS_STEPS} in [1, {sims}]")
    hist, _ = np.histogram(v, bins=visits_hist.EDGES)
    if hist.sum() != v.size:
        raise SystemExit(f"[17] the histogram's shares sum to {hist.sum() / v.size}")
    lines = visits_hist.report(v, "go9", cfg.search, BATCH, VISITS_WARM)
    for line in lines:
        print(f"[17] {line}", flush=True)
    move_s = [s for _, _, s in moves]
    out = {"config": "go9", "batch": BATCH, "warm": VISITS_WARM, "steps": VISITS_STEPS,
           "move_s": move_s, "wall_s": wall, "mean": float(v.mean()),
           "full_budget": float((v >= sims).mean()),
           "shares": (hist / v.size).tolist()}
    print(f"[17] go9 root visits on {card}: {len(moves)} self-play moves of "
          + ", ".join(f"{x:.2f}" for x in move_s)
          + f" s ({loop_len} K1 and {2 * loop_len} K2 launches each); {wall:.1f} s", flush=True)
    print("[17] " + json.dumps(out), flush=True)
    return out, (sum(k1 for k1, _ in counts), sum(k2 for _, k2 in counts))


def bench_path(card, dev) -> tuple:
    """[18]: the self-play bench in-process at ``JUMBO_BENCH`` (``bench_run``),
    then ``tools/bench_torch.py`` as a subprocess with ``BENCH_DP=2`` at
    ``BENCH_DP_RUN`` (two gloo ranks on the card): rc 0, its stdout lines,
    each rank's launches a timed move from its stderr line. Returns the
    numbers and the (K1, K2) launches by run (the dp=2 run's timed moves
    only: its warm-up runs in the ranks, uncounted)."""
    import subprocess

    from alpha_zero_tpu_torch.tools import bench

    name, batch, steps = JUMBO_BENCH
    _, jumbo, jumbo_launches = bench_run(f"[18] {name}", card, name, batch, steps, dev)
    out, launches = {name: jumbo}, {f"{name}_bench": jumbo_launches}

    name, batch, steps = BENCH_DP_RUN
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_CONFIG=name, BENCH_BATCH=str(batch), BENCH_STEPS=str(steps),
               BENCH_DP="2")
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "tools", "bench_torch.py")],
                          env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    label = f"[18] {name} B={batch} BENCH_DP=2"
    if proc.returncode != 0:
        raise SystemExit(f"{label}: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    check_bench_lines(label, lines, f"selfplay_env_steps_per_s_{name}_200sims_dp2", steps)
    (note,) = [x for x in proc.stderr.splitlines() if x.startswith(bench.LAUNCHES_PREFIX)]
    by_rank = json.loads(note[len(bench.LAUNCHES_PREFIX):])
    loop_len = bench.resolve(name).loop_len
    if by_rank != [[[loop_len, 2 * loop_len]] * steps] * 2:
        raise SystemExit(f"{label} launches a timed move by rank {by_rank}, expected "
                         f"{loop_len} and {2 * loop_len}")
    launches[f"{name}_bench_dp2"] = tuple(
        sum(move[k] for rank in by_rank for move in rank) for k in (0, 1))
    (dp_note,) = [x for x in proc.stderr.splitlines() if x.startswith("# dp=")]
    out["dp2"] = {"config": name, "batch": batch, "steps": steps,
                  "env_steps_per_s": lines[-1]["value"], "wall_s": wall}
    print(f"{label} (tools/bench_torch.py) on {card}: {lines[-1]['value']} env-steps/s over "
          f"{steps} timed moves; {dp_note[2:]}; {loop_len} K1 and {2 * loop_len} K2 "
          f"launches a move in each rank; {wall:.1f} s", flush=True)
    print("[18] " + json.dumps(out), flush=True)
    return out, launches


def jumbo_entry(jumbo, kernel, which) -> dict:
    """A kernel's ``go19_jumbo_b2048_*`` keys of the JSON line, from [14]."""
    times = jumbo[kernel]
    keys = ("ms", "cold_ms", "back_to_back_ms", "plain_ms", "bound_ms", "bound_by")
    return {"go19_jumbo_b2048_launches_a_move": jumbo["launches_a_move"][which],
            **{f"go19_jumbo_b2048_{k}": times[k] for k in keys}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    t_start = last = time.time()
    laps = {}

    def lap(label):
        """Seconds since the last lap, as ``laps[label]``."""
        nonlocal last
        laps[label], last = round(time.time() - last, 1), time.time()

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

    lap("[1]-[4]")
    # --- 5. The main path: go9 self-play through the bench.
    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    _, _, go9_launches = bench_run("[5] go9", card, "go9", BATCH, TIMED_MOVES, dev)
    launches = {"go9_selfplay": go9_launches}

    lap("[5]")
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

    lap("[6]")
    # --- 7. gomoku13 self-play: K1 and K2 at T=381, A=169 on a real search.
    g_cfg = config_lib.gomoku13()
    g_engine = build_engine(g_cfg.env)
    result, _, launches["gomoku13_selfplay"] = bench_run(
        "[7] gomoku13", card, "gomoku13", BATCH, GOMOKU_TIMED_MOVES, dev)
    check_tree("gomoku13 searched tree (int16 2-byte labels/liberties rows)",
               result.state.trees)
    del result
    check_engine_on_card("[7]", g_engine, 64, dev)

    lap("[7]")
    # --- 8. The training path: cli.train at go9 full width, the evaluator on.
    select.launches = writer.launches = 0
    train, ckpt_dir, train_cfg = train_path(card, dev)
    eval_k1, eval_k2 = train["eval_launches"]
    launches["go9_training"] = (select.launches - eval_k1, writer.launches - eval_k2)

    lap("[8]")
    # --- 9. Matches between [8]'s checkpoints: cli.match and an eval game.
    select.launches = writer.launches = 0
    matches, match_launches, game_launches = match_path(card, dev, ckpt_dir)
    launches["go9_eval"] = (eval_k1 + game_launches[0], eval_k2 + game_launches[1])
    launches["go9_match"] = match_launches

    lap("[9]")
    # --- 10. Data parallel: cli.train with parallel.dp=2, two ranks on the card.
    select.launches = writer.launches = 0
    dp, rank_launches = dp_path(card, dev)
    launches["go9_dp2"] = tuple(sum(x) for x in zip(*rank_launches))

    lap("[10]")
    # --- 11. The model axis: cli.train with parallel.mdl=2, two ranks on the card.
    select.launches = writer.launches = 0
    _, mdl_launches = mdl_path(card, dev)
    launches["go9_mdl2"] = tuple(sum(x) for x in zip(*mdl_launches))

    lap("[11]")
    # --- 12. The dry run: dp=2 x mdl=2, four ranks on the card.
    select.launches = writer.launches = 0
    _, dryrun_launches = dryrun_path(card, dev)
    launches["dryrun"] = tuple(sum(x) for x in zip(*dryrun_launches))

    lap("[12]")
    # --- 13. cli.analysis, then the GUI's AI-vs-AI game at go19_jumbo width.
    select.launches = writer.launches = 0
    gui, launches["go19_gui"] = gui_path(card, dev)

    lap("[13]")
    # --- 14. go19_jumbo self-play at B=2048 and training at batch 2048.
    select.launches = writer.launches = 0
    jumbo, launches["go19_b2048"] = jumbo_path(card, dev)
    lap("[14]")

    # --- 15. The engine parity sweep: go9, gomoku13 and go19 on the card vs the CPU.
    sweep_path(card, dev)
    score = score_path(card, dev)
    lap("[15]")

    # --- 16. The backfill evaluator on [8]'s checkpoints, against [8]'s rows.
    select.launches = writer.launches = 0
    _, launches["go9_backfill"] = backfill_path(card, dev, train_cfg, ckpt_dir, train)
    shutil.rmtree(ckpt_dir)  # 24 MB a checkpoint; the CSVs stay
    lap("[16]")

    # --- 17. The root-visit histogram at go9, B=1024.
    select.launches = writer.launches = 0
    _, launches["go9_visits"] = visits_path(card, dev)
    lap("[17]")

    # --- 18. The self-play bench at go19_jumbo, and its CLI at dp=2.
    _, bench_launches = bench_path(card, dev)
    launches.update(bench_launches)
    lap("[18]")
    print(f"chip_smoke: seconds by phase {json.dumps(laps)}; {time.time() - t_start:.1f} s "
          "in all", flush=True)

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
        "go19_jumbo_b1_ms": gui["k2"]["ms"],
        "go19_jumbo_b1_cold_ms": gui["k2"]["cold_ms"],
        "go19_jumbo_b1_plain_ms": gui["k2"]["plain_ms"],
        "go19_jumbo_b1_bound_ms": gui["k2"]["bound_ms"],
        **jumbo_entry(jumbo, "k2", 1),
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
        "go19_jumbo_b1_ms": gui["k1"]["ms"],
        "go19_jumbo_b1_cold_ms": gui["k1"]["cold_ms"],
        "go19_jumbo_b1_plain_ms": gui["k1"]["plain_ms"],
        "go19_jumbo_b1_bound_ms": gui["k1"]["bound_ms"],
        **jumbo_entry(jumbo, "k1", 0),
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,
    }] + scatter_entries + [{
        "name": "score_area",
        "route": "cuda",
        "source": "alpha_zero_tpu_torch/csrc/score_area.cu",
        "replaces": None,
        "max_abs_err": 0.0,
        **{f"{k}_{name}": v for k, r in score.items() for name, v in r.items()},
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
