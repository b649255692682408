"""The actor/learner pipeline as a generation loop, on one device or on
each of several data-parallel ranks.

The port of ``alpha_zero_tpu.training.pipeline``. The actor fleet is one
batched self-play step over all games, so the topology is a sequential
loop:

    repeat:
      1. self-play until ``games_per_ckpt`` new games finish
         (``min_games`` for the very first generation)
      2. run ``ckpt_interval`` SGD steps on replay samples
      3. checkpoint, refresh the self-play net, CSV metrics and
         resign-threshold controller updates

Kept from the JAX package: games-per-checkpoint pacing, the dynamic
resignation threshold with hard resets and FP-rate bookkeeping, the
harvest two steps behind the dispatch, CSV schemas, SGF dumps, replay
save/restore, checkpoint resume with the crash-resume game quota, the
straddling-games option (``train.drop_straddling_games``).

The learner keeps float32 master weights; self-play runs a copy in the
config's inference dtype (bf16 at go9), refreshed from the master weights
after every train generation.

The evaluator (``enable_evaluator``) plays each new checkpoint against the
previous one after its generation and writes ``evaluation.csv`` and an eval
SGF, inline or (``run.eval_async``) on a worker thread that gets a copy of
the weights; a failed evaluation is logged and skips its row.

Data and model parallel (a process group of ``parallel.dp *
parallel.mdl`` ranks, or ``parallel.num_processes`` with a coordinator;
``cli/train.py`` starts them and ``parallel/`` has the collectives; rank r
is model group ``dp_index = r // mdl``): every model group runs this loop
on its own games (the game batch split over the model groups, or
``selfplay_batch_size`` a group with a coordinator) and its own replay
partition, with its own self-play seed stream (drawn from ``dp_index``)
and its own ``actor{dp_index}.csv`` and ``replay_state_p{dp_index}.npz``,
written by its ``mdl_index`` 0. The ranks of a model group are replicas:
the same games, draws, trees and replay rows, each computing its slices
of the net's wide layers (``models/resnet.py``). A fence every
``parallel.fence_interval`` self-play steps, and once at the end of the
loop, sums the finished games over the model groups, so every rank leaves
self-play on the same step; rank 0 feeds the global counts to the
resignation controller and broadcasts its threshold. Each model group
samples ``batch_size / dp`` rows, and trains only when every group can
sample; the step is the global batch's (BatchNorm moments and gradients
across model groups). Rank 0 alone writes ``training.csv``
(``total_games`` and ``total_samples`` counted over all model groups), the
checkpoints (in the whole layout, gathered over model group 0) and the
evaluator's rows; every rank refreshes its self-play net, slice by slice.

``Trainer.profile`` traces a few self-play steps and one train step with
``torch.profiler`` into a Chrome trace.
"""

from __future__ import annotations

import copy
import csv
import os
import queue
import threading
from collections import deque, namedtuple
import math
from typing import Callable, Optional

import numpy as np
import torch

from alpha_zero_tpu_torch.config import AlphaZeroConfig
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.gomoku import GomokuEngine
from alpha_zero_tpu_torch.models.resnet import (build_network, gather_state_dict,
                                                to_inference_dtype)
from alpha_zero_tpu_torch.ops.symmetry import random_transform_id
from alpha_zero_tpu_torch.parallel import mesh as mesh_lib
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner as learner_lib
from alpha_zero_tpu_torch.training import selfplay as selfplay_lib
from alpha_zero_tpu_torch.training.replay import UniformReplay
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.csv_writer import CsvWriter
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import Timer, create_logger, get_time_stamp

_PlayerMove = namedtuple("PlayerMove", ["color", "move"])


def build_engine(env_cfg):
    if env_cfg.game == "go":
        return GoEngine(board_size=env_cfg.board_size, num_stack=env_cfg.num_stack,
                        komi=env_cfg.komi, max_steps=env_cfg.max_steps)
    if env_cfg.game == "gomoku":
        return GomokuEngine(board_size=env_cfg.board_size, num_stack=env_cfg.num_stack,
                            num_to_win=env_cfg.num_to_win, max_steps=env_cfg.max_steps)
    raise ValueError(f"unknown game {env_cfg.game}")


def maybe_adjust_resign_threshold(current_v: float, current_rate: float,
                                  target_rate: float, min_v: float = -0.9999,
                                  smoothing_factor: float = 0.5) -> float:
    """Threshold controller update (reference pipeline.py:656-670)."""
    rate_delta = current_rate - target_rate
    if rate_delta <= 0:
        return current_v
    new_v = current_v + current_v * rate_delta
    smoothed_v = smoothing_factor * new_v + (1 - smoothing_factor) * current_v
    return round(max(min_v, smoothed_v), 4)


class ResignController:
    """Dynamic resignation threshold with FP-rate tracking, updated game by
    game (reference pipeline.py:449-460, 519-553)."""

    def __init__(self, resign_cfg, games_per_ckpt: int, logger) -> None:
        self.cfg = resign_cfg
        self.games_per_ckpt = games_per_ckpt
        self.logger = logger
        self.resign_count = 0
        self.last_resign_count = 0
        self.could_won_count = 0
        if not resign_cfg.enabled:
            self.threshold = -1.0
        elif resign_cfg.no_resign_games > 0:
            self.threshold = -1.0
        else:
            self.threshold = resign_cfg.init_resign_threshold

    def on_game(self, stats: dict, num_games_added: int) -> None:
        cfg = self.cfg
        if not cfg.enabled or num_games_added < cfg.no_resign_games:
            return
        if stats.get("is_resign_disabled") and stats.get("is_marked_for_resign"):
            self.resign_count += 1
            if stats.get("is_could_won"):
                self.could_won_count += 1

        if num_games_added == cfg.no_resign_games or (
            cfg.reset_fp_interval > 0 and num_games_added % cfg.reset_fp_interval == 0
        ):
            self.resign_count = self.last_resign_count = self.could_won_count = 0
            self.threshold = cfg.init_resign_threshold
            self.logger.info(f"Reset resignation threshold to {self.threshold}")
            return

        adjust_every = int(self.games_per_ckpt * 0.5 * cfg.disable_resign_ratio * 0.5)
        if (
            adjust_every > 0
            and self.resign_count > self.last_resign_count
            and self.resign_count % adjust_every == 0
        ):
            self.last_resign_count = self.resign_count
            self._adjust()

    def _adjust(self) -> None:
        cfg = self.cfg
        fp_rate = 0.0 if self.resign_count == 0 else round(
            self.could_won_count / self.resign_count, 4
        )
        new_threshold = maybe_adjust_resign_threshold(
            self.threshold, fp_rate, cfg.target_fp_rate
        )
        if new_threshold != self.threshold:
            self.logger.info(
                f"Resignation FP {fp_rate} vs target {cfg.target_fp_rate}: "
                f"threshold {self.threshold} -> {new_threshold}"
            )
            self.threshold = new_threshold

    def on_games_global(self, num_marked: int, num_could_won: int,
                        games_before: int, games_after: int) -> None:
        """The data-parallel update, on rank 0 at each fence: the counts of
        every rank's games since the last fence, so the controller samples
        the whole stream. Reset and adjust points are count windows crossed
        between ``games_before`` and ``games_after``, which matches the game
        by game cadence up to one fence interval."""
        cfg = self.cfg
        if not cfg.enabled or games_after < cfg.no_resign_games:
            return
        self.resign_count += num_marked
        self.could_won_count += num_could_won
        crossed_start = games_before < cfg.no_resign_games <= games_after
        crossed_reset = cfg.reset_fp_interval > 0 and (
            games_after // cfg.reset_fp_interval
            > max(games_before, cfg.no_resign_games) // cfg.reset_fp_interval
        )
        if crossed_start or crossed_reset:
            self.resign_count = self.last_resign_count = self.could_won_count = 0
            self.threshold = cfg.init_resign_threshold
            self.logger.info(f"Reset resignation threshold to {self.threshold}")
            return
        adjust_every = int(self.games_per_ckpt * 0.5 * cfg.disable_resign_ratio * 0.5)
        if adjust_every > 0 and self.resign_count - self.last_resign_count >= adjust_every:
            self.last_resign_count = self.resign_count
            self._adjust()


class Trainer:
    """Owns all state of a training run; ``run()`` drives it to completion.

    Randomness comes from three streams drawn from ``run.seed``: the initial
    weights, the self-play draws (a generator on ``device``; each model
    group's own when data parallel, the same on its replicas) and the
    augmentation picks (a host generator, the same on every rank, as one
    pick serves the whole global batch).

    Data or model parallel, the process group must be up before the Trainer
    is built (``parallel.multihost.initialize`` with ``parallel.mdl``;
    ``cli/train.py`` does it), with ``parallel.dp * parallel.mdl`` ranks, or
    ``parallel.num_processes`` with a coordinator address, and ``device``
    the rank's own."""

    def __init__(self, cfg: AlphaZeroConfig, device="cuda") -> None:
        par = cfg.parallel
        self.world = multihost.world_size()
        self.rank = multihost.rank()
        self.mesh = mesh_lib.make_mesh(
            par.num_processes if par.coordinator_address else par.dp * par.mdl, par.mdl)
        if self.mesh != multihost.mesh():
            raise RuntimeError(
                f"the config asks for {self.mesh} and the process group has "
                f"{multihost.mesh()}: start the ranks with cli.train, or call "
                "parallel.multihost.initialize (with parallel.mdl) in each before "
                "building the Trainer")
        self.dp_index, self.mdl_index = self.mesh.coords(self.rank)
        self.multihost = self.world > 1
        self.is_host0 = self.rank == 0
        # The per-model-group files (actor CSV, SGF, replay state) are
        # written by one replica.
        self.writes_group_files = self.mdl_index == 0
        # Games a model group: the local groups split the game batch; with a
        # coordinator it counts one group's games, as JAX's counts a host's.
        split = 1 if par.coordinator_address else self.mesh.dp
        if par.selfplay_batch_size % split:
            raise ValueError(f"parallel.selfplay_batch_size={par.selfplay_batch_size} must "
                             f"divide by parallel.dp={split}")
        batch = par.selfplay_batch_size // split
        if cfg.train.batch_size % self.mesh.dp:
            raise ValueError(f"train.batch_size={cfg.train.batch_size} must divide by the "
                             f"{self.mesh.dp} model groups")
        self.local_batch_size = cfg.train.batch_size // self.mesh.dp
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = create_logger(cfg.run.log_level)
        self.engine = build_engine(cfg.env)

        for d in (cfg.run.ckpt_dir, cfg.run.logs_dir, cfg.run.save_sgf_dir):
            if d:
                os.makedirs(d, exist_ok=True)

        n = cfg.env.board_size
        obs_shape = (n, n, cfg.env.num_planes)
        init_seed, sp_seed, aug_seed = np.random.SeedSequence(cfg.run.seed).generate_state(3)
        if self.mesh.dp > 1:
            # Decorrelate the model groups' games (JAX folds in the process
            # index); a group's replicas draw the same numbers.
            sp_seed = np.random.SeedSequence([int(sp_seed), self.dp_index]).generate_state(1)[0]
        self.generator = torch.Generator(device=self.device).manual_seed(int(sp_seed))
        self.aug_generator = torch.Generator().manual_seed(int(aug_seed))
        net = build_network(cfg.env, cfg.network, device=self.device,
                            seed=int(init_seed), dtype="float32", mesh=self.mesh)
        self.train_state = learner_lib.create_train_state(net, cfg.train)
        self.train_step = learner_lib.make_train_step(
            cfg.network.inference_dtype, argument_data=cfg.train.argument_data)
        # The self-play net: a copy in the inference dtype, BatchNorm in
        # float32 (see _refresh_play_net).
        self.play_net = to_inference_dtype(
            copy.deepcopy(net), cfg.network.inference_dtype).eval()
        self.selfplay_step = selfplay_lib.make_selfplay_step(
            self.engine, self.play_net, cfg.search, cfg.resign,
            deterministic=False, root_noise=True, device=self.device,
        )

        self.replay = UniformReplay(
            capacity=cfg.train.replay_capacity, obs_shape=obs_shape,
            num_actions=cfg.env.num_actions, seed=cfg.run.seed,
        )
        self.resign_controller = ResignController(
            cfg.resign, cfg.train.games_per_ckpt, self.logger
        )

        self.sp_state = selfplay_lib.init_selfplay_state(
            self.engine, batch, self.generator,
            resign_threshold=self.resign_controller.threshold,
            disable_resign_ratio=cfg.resign.disable_resign_ratio,
            reuse_num_simulations=(
                cfg.search.num_simulations if cfg.search.reuse_subtree else None
            ),
            device=self.device,
        )
        self.accumulator = selfplay_lib.EpisodeAccumulator(
            batch, num_planes=cfg.env.num_planes)

        self.actor_writer = CsvWriter(self._actor_csv_path())
        self.train_writer = CsvWriter(os.path.join(cfg.run.logs_dir, "training.csv"),
                                      buffer_size=1)  # written by rank 0 only
        self.eval_writer = CsvWriter(os.path.join(cfg.run.logs_dir, "evaluation.csv"),
                                     buffer_size=1)
        self.evaluator = None  # built by enable_evaluator(), on rank 0
        self._evaluating = False  # enable_evaluator() was called
        self._eval_failures = 0  # consecutive failed evaluations
        self._eval_queue: Optional[queue.Queue] = None
        self._replay_path = os.path.join(
            cfg.run.ckpt_dir,
            f"replay_state_p{self.dp_index}.npz" if self.mesh.dp > 1 else "replay_state.npz")
        self._last_replay_save = 0
        self.timer = Timer()
        self.training_steps = 0
        self.played_games = 0
        self.latest_ckpt_path: Optional[str] = None

        # Resume.
        if cfg.run.load_ckpt and os.path.exists(cfg.run.load_ckpt):
            ckpt_lib.restore_checkpoint(cfg.run.load_ckpt, self.train_state)
            self.training_steps = self.train_state.training_steps
            self._refresh_play_net()
            self.logger.info(
                f"Resumed from checkpoint {cfg.run.load_ckpt} at step {self.training_steps}"
            )
        if cfg.run.load_replay and os.path.exists(cfg.run.load_replay):
            try:
                self.replay.load(cfg.run.load_replay)
                self.logger.info(f"Loaded replay state from {cfg.run.load_replay}")
            except Exception as e:  # noqa: BLE001
                # A corrupt snapshot must not crash-loop a supervisor:
                # resume with an empty replay.
                self.logger.exception(
                    f"Replay snapshot {cfg.run.load_replay} unreadable "
                    f"({e}); starting with an empty replay")

        # Games and samples of every rank (advanced by the harvest, or by
        # the fences when data parallel).
        self.global_games_added = self.replay.num_games_added
        self.global_samples_added = self.replay.num_samples_added
        if self.multihost:
            self.global_games_added, self.global_samples_added = (int(x) for x in (
                multihost.global_sum([self.replay.num_games_added,
                                      self.replay.num_samples_added])))
            # Every model group starts from the first group's weights and
            # optimizer state, slice by slice (the same bits when all built
            # them from run.seed).
            net = self.train_state.net
            multihost.broadcast_tensors(
                list(net.state_dict().values())
                + [self.train_state.optimizer.state[p]["momentum_buffer"]
                   for p in net.parameters() if p in self.train_state.optimizer.state])
            self._refresh_play_net()

        # Resign-threshold continuity: the controller enables the threshold
        # on the games_added == no_resign_games crossing, which a resumed run
        # past that point never sees again. Re-seed from the last actor-CSV
        # row's recorded threshold, falling back to the init threshold.
        if (
            cfg.resign.enabled
            and self.engine.has_resign_move
            and self.global_games_added >= cfg.resign.no_resign_games
            and self.resign_controller.threshold <= -1.0
        ):
            t = self._last_recorded_resign_threshold()
            self.resign_controller.threshold = (
                t if t is not None else cfg.resign.init_resign_threshold
            )
            self.logger.info(
                f"Resign threshold resumed at {self.resign_controller.threshold}"
            )
        self.resign_controller.threshold = multihost.broadcast_from_host0(
            self.resign_controller.threshold)

    def _actor_csv_path(self) -> str:
        return os.path.join(self.cfg.run.logs_dir, f"actor{self.dp_index}.csv")

    def _last_recorded_resign_threshold(self) -> Optional[float]:
        """Last ACTIVE threshold in this rank's actor CSV. Rows with -1.0 are
        pre-activation; an active controller never reaches -1.0 (its floor
        is -0.9999), so only values above -1.0 count."""
        path = self._actor_csv_path()
        try:
            last = None
            with open(path) as f:
                for row in csv.DictReader(f):
                    try:
                        t = float(row["resign_threshold"])
                    except (KeyError, ValueError):
                        continue
                    if t > -1.0:
                        last = t
            return last
        except OSError:
            return None

    def _refresh_play_net(self) -> None:
        """Copies the master weights into the self-play net, each tensor cast
        to its own dtype (BatchNorm's stay float32); with the model axis,
        this rank's slices into its slices."""
        self.play_net.load_state_dict(self.train_state.net.state_dict())

    # ------------------------------------------------------------------
    def _to_host(self, out: selfplay_lib.StepOutput):
        """Starts the device-to-host copies of a step's outputs; returns
        them with the event that marks their completion (None on the CPU)."""
        if self.device.type != "cuda":
            return out, None
        host = selfplay_lib.StepOutput(*(x.to("cpu", non_blocking=True) for x in out))
        done = torch.cuda.Event()
        done.record()
        return host, done

    def selfplay_until(self, target_new_games: float,
                       max_steps: Optional[int] = None) -> int:
        """Runs self-play until ``target_new_games`` finish (across all
        ranks when data parallel: every rank leaves on the same step);
        returns how many did."""
        new_games = 0
        steps = 0
        # Data parallel: the count advances only at fences, every
        # ``fence_interval`` steps, so it is the same on every rank; between
        # fences each rank counts its finished, resign-marked, could-have-won
        # games and their samples in ``pending``.
        fence_k = max(1, self.cfg.parallel.fence_interval)
        pending = [0, 0, 0, 0]
        # Harvest two steps behind the dispatch: step k's outputs are read
        # on the host while steps k+1 and k+2 run. The price is two steps
        # of staleness in the resign threshold and the game-count exit
        # check; a drained tail may carry the count past the target.
        in_flight = deque()
        harvest_depth = 2
        while new_games < target_new_games:
            with self.timer:
                self.sp_state, out = self.selfplay_step(
                    self.sp_state, self.generator, self.resign_controller.threshold)
                in_flight.append(self._to_host(out))
                if len(in_flight) > harvest_depth:
                    new_games += self._harvest_step(*in_flight.popleft(), pending)
            steps += 1
            if self.multihost and steps % fence_k == 0:
                new_games += self._fence(pending)
            if max_steps is not None and steps >= max_steps:
                break
        while in_flight:
            # Every output must still enter the accumulator (per-lane
            # histories grow one move per step).
            new_games += self._harvest_step(*in_flight.popleft(), pending)
        if self.multihost:
            # One more fence for the partial window and the drained steps
            # (JAX fences only a partial window, so a loop that ends on a
            # fence leaves its drained games out of the global count). It
            # depends on nothing but the lockstep loop, so every rank joins.
            new_games += self._fence(pending)
        return new_games

    def _harvest_step(self, out: selfplay_lib.StepOutput,
                      copied: Optional[torch.cuda.Event], pending: list) -> int:
        """Host-side processing of one self-play step's output: accumulate
        per-lane histories, fold finished games into replay / resign
        controller / CSV / SGF. Returns the new-game count; data parallel,
        it counts into ``pending`` for the next fence and returns 0."""
        cfg = self.cfg
        if copied is not None:
            copied.synchronize()
        finished = self.accumulator.add_step(out)
        if cfg.train.drop_straddling_games:
            finished = [game for game in finished if not game.stats.pop("stale")]
        else:
            for game in finished:
                game.stats.pop("stale", None)
        for game in finished:
            self.played_games += 1
            self.replay.add_game(game.states, game.pi_probs, game.values)
            if self.multihost:
                pending[0] += 1
                pending[1] += int(game.stats["is_marked_for_resign"])
                pending[2] += int(game.stats["is_could_won"])
                pending[3] += game.stats["game_length"]
            else:
                self.global_games_added += 1
                self.global_samples_added += game.stats["game_length"]
                self.resign_controller.on_game(game.stats, self.replay.num_games_added)

            row = {
                "datetime": get_time_stamp(),
                "game_length": game.stats["game_length"],
                "game_result": game.stats["game_result"],
            }
            if self.engine.has_pass_move:
                row["num_passes"] = game.stats["num_passes"]
            if self.engine.has_resign_move:
                row["is_resign_disabled"] = game.stats["is_resign_disabled"]
                row["is_marked_for_resign"] = game.stats["is_marked_for_resign"]
                row["is_could_won"] = game.stats["is_could_won"]
                row["marked_resign_player"] = game.stats["marked_resign_player"]
                row["resign_threshold"] = self.resign_controller.threshold
            row["time_per_game"] = round(self.timer.mean_time(), 4)
            row["training_steps"] = self.training_steps
            if self.writes_group_files:
                self.actor_writer.write(row)

            if (
                self.writes_group_files
                and cfg.run.save_sgf_dir
                and cfg.run.save_sgf_interval > 0
                and self.played_games % cfg.run.save_sgf_interval == 0
            ):
                self._save_sgf(game)

            if self.replay.num_games_added % 10000 == 0:
                self.logger.info(
                    f"Collected {self.replay.num_games_added} self-play games, "
                    f"{self.replay.num_samples_added} samples."
                )
            if (
                cfg.train.save_replay_interval > 0
                and self.replay.num_games_added
                >= self._last_replay_save + cfg.train.save_replay_interval
            ):
                # Threshold, not modulo: several games can finish in one
                # lockstep step, hopping over the exact multiple.
                self._last_replay_save = self.replay.num_games_added
                if self.writes_group_files:
                    self.replay.save(self._replay_path)
        return 0 if self.multihost else len(finished)

    def _fence(self, pending: list) -> int:
        """One fence: sums ``pending`` (finished, resign-marked,
        could-have-won games, samples) across ranks and zeroes it, feeds the
        global counts to rank 0's resignation controller and broadcasts its
        threshold back. Returns the global finished-game delta."""
        games, marked, could_won, samples = (int(x) for x in multihost.global_sum(pending))
        pending[:] = [0] * len(pending)
        before = self.global_games_added
        self.global_games_added += games
        self.global_samples_added += samples
        if self.is_host0:
            self.resign_controller.on_games_global(marked, could_won, before,
                                                   self.global_games_added)
        self.resign_controller.threshold = multihost.broadcast_from_host0(
            self.resign_controller.threshold)
        return games

    def _save_sgf(self, game: selfplay_lib.FinishedGame) -> None:
        content = sgf_lib.make_sgf(
            board_size=self.cfg.env.board_size,
            move_history=[_PlayerMove(c, m) for c, m in game.moves],
            result_string=game.stats["game_result"],
            ruleset="Chinese" if self.cfg.env.game == "go" else "",
            komi=self.cfg.env.komi if self.cfg.env.game == "go" else "",
            date=get_time_stamp(),
        )
        path = os.path.join(
            self.cfg.run.save_sgf_dir,
            f"actor{self.dp_index}_{get_time_stamp(True)}_{self.played_games}.sgf",
        )
        with open(path, "w") as f:
            f.write(content)

    # ------------------------------------------------------------------
    def _train_once(self) -> Optional[learner_lib.TrainMetrics]:
        """One SGD step on ``local_batch_size`` replay rows, or None when
        the replay (any model group's, data parallel) is too small to
        sample."""
        batch = self.replay.sample(self.local_batch_size)
        # Collective control flow: every rank trains only if all can sample.
        if multihost.global_game_count(int(batch is not None)) < self.mesh.dp:
            batch = None
        if batch is None:
            return None
        states, pis, values = (torch.from_numpy(x).to(self.device)
                               for x in (batch.state, batch.pi_prob, batch.value))
        metrics = self.train_step(self.train_state, states, pis, values,
                                  random_transform_id(self.aug_generator))
        self.training_steps += 1
        return metrics

    def train_generation(self) -> None:
        """Runs ``ckpt_interval`` SGD steps, checkpoints, and refreshes the
        self-play net."""
        cfg = self.cfg
        target = self.training_steps + cfg.train.ckpt_interval
        while self.training_steps < target:
            metrics = self._train_once()
            if metrics is None:
                self.logger.warning("replay too small to sample; skipping update")
                break
            if self.is_host0 and (
                self.training_steps % cfg.train.log_interval == 0
                or self.training_steps % cfg.train.ckpt_interval == 0
            ):
                self.train_writer.write({
                    "datetime": get_time_stamp(),
                    "training_steps": self.training_steps,
                    "policy_loss": float(metrics.policy_loss),
                    "value_loss": float(metrics.value_loss),
                    "learning_rate": metrics.learning_rate,
                    "total_games": self.global_games_added,
                    "total_samples": self.global_samples_added,
                })

        self.latest_ckpt_path = ckpt_lib.checkpoint_path(cfg.run.ckpt_dir,
                                                         self.training_steps)
        if self.dp_index == 0:  # model group 0 gathers the whole layout, rank 0 writes it
            ckpt_lib.save_checkpoint(cfg.run.ckpt_dir, self.train_state, self.training_steps,
                                     write=self.is_host0)
        multihost.barrier()  # the checkpoint is on disk before any rank goes on
        self._refresh_play_net()
        if cfg.train.drop_straddling_games:
            # Games in flight at the weight switch are discarded when they
            # finish.
            self.accumulator.mark_all_stale()
        self.logger.info(
            f"Checkpoint for step {self.training_steps} at {self.latest_ckpt_path}"
        )

    # ------------------------------------------------------------------
    def profile(self, num_steps: int = 3, out_dir: Optional[str] = None) -> str:
        """Traces ``num_steps`` self-play steps (harvest included) and one
        train step with ``torch.profiler`` (CPU activities, and CUDA's on
        the card) under ``record_function`` ranges ``selfplay`` and
        ``train_step``; writes a Chrome trace ``trace_rank{r}.json`` to
        ``out_dir`` (default ``logs_dir/profile``) and returns its path.
        Data or model parallel, every rank calls it together (fences,
        gathers, train step)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        out_dir = out_dir or os.path.join(self.cfg.run.logs_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function("selfplay"):
                self.selfplay_until(math.inf, max_steps=num_steps)
            with record_function("train_step"):
                if self._train_once() is None:
                    self.logger.warning("replay too small to sample; no train step traced")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        path = os.path.join(out_dir, f"trace_rank{self.rank}.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")
        return path

    def _games_at_last_ckpt(self) -> Optional[int]:
        """total_games at the last training.csv row whose step is at or
        below the resumed checkpoint's."""
        path = os.path.join(self.cfg.run.logs_dir, "training.csv")
        try:
            with open(path) as f:
                best = None
                for row in csv.DictReader(f):
                    step = int(row["training_steps"])
                    if step <= int(self.training_steps):
                        best = int(row["total_games"])
            return best
        except (OSError, KeyError, ValueError):
            return None

    # ------------------------------------------------------------------
    def enable_evaluator(self) -> None:
        """Builds the evaluator: latest-vs-previous matches and Elo, plus the
        pro-game metrics when ``run.eval_games_dir`` exists (its dataset
        cached as an npz in ``run.ckpt_dir``). A resumed run continues the
        Elo curve from the last ``evaluation.csv`` row and plays its first
        new checkpoint against the resumed weights. Data parallel, only rank
        0 has an evaluator: it plays from its resident weights. With the
        model axis its nets are whole ones, loaded with the weights gathered
        over model group 0 (its searches have no peers to gather with), so
        every rank calls this."""
        from alpha_zero_tpu_torch.eval.dataset import build_eval_dataset
        from alpha_zero_tpu_torch.eval.evaluator import Evaluator

        self._evaluating = True
        resumed = self._whole_weights() if self.training_steps > 0 else None
        if not self.is_host0:
            return
        cfg = self.cfg
        dataset = None
        if cfg.run.eval_games_dir and os.path.exists(cfg.run.eval_games_dir):
            n = cfg.env.board_size
            dataset = build_eval_dataset(
                cfg.run.eval_games_dir, n, cfg.env.num_stack, logger=self.logger,
                cache_path=os.path.join(cfg.run.ckpt_dir, f"eval_dataset_{n}x{n}.npz"),
                device=self.device)
        net = self.train_state.net
        if self.mesh.mdl > 1:
            net = build_network(cfg.env, cfg.network, device=self.device, dtype="float32")
        self.evaluator = Evaluator(
            self.engine, net, cfg.search,
            inference_dtype=cfg.network.inference_dtype,
            default_rating=cfg.run.default_rating, dataset=dataset,
            eval_games=cfg.run.eval_games, device=self.device)
        if self.training_steps > 0:
            rating = self._last_recorded_rating()
            self.evaluator.restore_continuity(
                rating if rating is not None else cfg.run.default_rating,
                prev_weights=resumed)
            if rating is not None:
                self.logger.info(
                    f"Evaluator resumed: Elo {rating:.2f} from the last "
                    f"evaluation.csv row, previous model = the resumed checkpoint")

    def _whole_weights(self) -> Optional[dict]:
        """The master weights in the whole layout on rank 0, None on every
        other rank. With the model axis a collective over model group 0,
        whose ranks must all call it."""
        if self.dp_index != 0:
            return None
        weights = gather_state_dict(self.train_state.net)
        return weights if self.is_host0 else None

    def _last_recorded_rating(self) -> Optional[float]:
        """The last black (that is, promoted) Elo rating in evaluation.csv."""
        path = os.path.join(self.cfg.run.logs_dir, "evaluation.csv")
        try:
            with open(path) as f:
                rows = list(csv.DictReader(f))
            if not rows:
                return None
            return float(rows[-1]["black_elo_rating"])
        except (OSError, KeyError, ValueError):
            return None

    def start_async_evaluator(self) -> None:
        """Runs evaluations on a worker thread, so the next generation's
        self-play starts right after training. One worker keeps the
        checkpoints in order (Elo continuity); its work shares the device's
        stream with self-play. A crash loses the queued evaluations' rows."""
        if self._eval_queue is not None:
            return
        self._eval_queue = queue.Queue()

        def worker():
            while True:
                item = self._eval_queue.get()
                if item is None:
                    self._eval_queue.task_done()
                    return
                weights, steps = item
                try:
                    self._evaluate_and_record(weights, steps)
                except Exception:  # noqa: BLE001 - keep the worker alive
                    self.logger.exception(f"async evaluation for step {steps} failed")
                finally:
                    self._eval_queue.task_done()

        self._eval_thread = threading.Thread(target=worker, name="evaluator", daemon=True)
        self._eval_thread.start()

    def finish_async_evaluator(self) -> None:
        if self._eval_queue is None:
            return
        self._eval_queue.join()
        self._eval_queue.put(None)
        self._eval_thread.join()
        self._eval_queue = None

    def run_evaluation(self) -> Optional[dict]:
        """Evaluates the current weights; writes evaluation.csv and the eval
        SGF. In async mode the worker gets a copy of the weights (the next
        train step updates the master weights in place) and this returns
        None. Every rank calls it (model group 0 gathers the weights)."""
        if not self._evaluating:
            return None
        weights = self._whole_weights()
        if self.evaluator is None:
            return None
        if self._eval_queue is not None:
            self._eval_queue.put(({k: v.detach().clone() for k, v in weights.items()},
                                  self.training_steps))
            return None
        return self._evaluate_and_record(weights, self.training_steps)

    def _evaluate_and_record(self, weights, training_steps) -> Optional[dict]:
        try:
            stats = self.evaluator.evaluate(weights, seed=training_steps)
        except Exception as e:  # noqa: BLE001
            # A failed evaluation skips this checkpoint's row and training
            # goes on; repeated failures are escalated to errors.
            self._eval_failures += 1
            log = self.logger.error if self._eval_failures >= 3 else self.logger.warning
            log(f"evaluation failed for step {training_steps} "
                f"({self._eval_failures} consecutive): {e}", exc_info=True)
            return None
        self._eval_failures = 0
        moves = stats.pop("_moves", [])
        sgf_result = stats.pop("_sgf_result", stats.get("game_result", ""))
        self.eval_writer.write({"datetime": get_time_stamp(),
                                "training_steps": training_steps, **stats})
        if self.cfg.run.save_sgf_dir and moves:
            content = sgf_lib.make_sgf(
                board_size=self.cfg.env.board_size,
                move_history=moves,
                result_string=sgf_result,
                ruleset="Chinese" if self.cfg.env.game == "go" else "",
                komi=self.cfg.env.komi if self.cfg.env.game == "go" else "",
                date=get_time_stamp(),
            )
            path = os.path.join(self.cfg.run.save_sgf_dir,
                                f"eval_training_steps_{training_steps}.sgf")
            with open(path, "w") as f:
                f.write(content)
        return stats

    # ------------------------------------------------------------------
    def run(self, on_checkpoint: Optional[Callable[["Trainer"], None]] = None) -> None:
        """Full training loop to ``max_training_steps``."""
        cfg = self.cfg
        if cfg.run.eval_async and self.evaluator is not None:
            self.start_async_evaluator()
        # The first generation is the min_games warm-up, which counts the
        # replay's existing games (every rank's). A run resumed from a
        # checkpoint is past warm-up: it collects games_per_ckpt new games
        # before training.
        first = self.training_steps == 0
        resumed = not first
        while self.training_steps < cfg.train.max_training_steps:
            target = cfg.train.min_games if first else cfg.train.games_per_ckpt
            already = self.global_games_added if first else 0
            if resumed:
                # Crash-resume mid-generation: credit the games collected
                # since the last checkpoint (training.csv logs total_games
                # per step; the restored replays carry num_games_added).
                # Rank 0 reads training.csv and the others take its count.
                at_ckpt = self._games_at_last_ckpt() if self.is_host0 else None
                if at_ckpt is not None:
                    already = max(0, self.global_games_added - at_ckpt)
                already = int(multihost.broadcast_from_host0(already))
                resumed = False
            self.selfplay_until(max(0, target - already))
            first = False
            self.train_generation()
            self.run_evaluation()
            if on_checkpoint is not None:
                on_checkpoint(self)
        self.finish_async_evaluator()
        self.actor_writer.close()
        self.train_writer.close()
        self.eval_writer.close()


def train(cfg: AlphaZeroConfig, device="cuda", **kwargs) -> Trainer:
    trainer = Trainer(cfg, device=device)
    trainer.run(**kwargs)
    return trainer
