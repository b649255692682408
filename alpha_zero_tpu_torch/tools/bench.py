"""Self-play throughput bench: env-steps/s of batched self-play.

The port of ``bench.py``. One env-step is one move of one game; the bench
plays ``steps`` timed self-play moves of ``batch`` games from the empty
board after ``warmup`` moves, with the config's net at random weights of
seed 0 in its inference dtype and resignation off, and prints a JSON line
after every timed move (``partial: true`` on all but the last), so a run
cut short still leaves a number. The lines' keys and metric names are
``bench.py``'s, its go9 name (``..._9x9go_200sims``, whatever the
simulation count) included; ``vs_baseline`` is against the reference
fleet's 418 env-steps/s (BASELINE.md). Simulations a second are reported
two ways: ``nn_sims_per_s`` counts the simulation loop's length
(``max_new_sims`` under subtree reuse, else ``num_simulations - 1``),
``budget_sims_per_s`` the whole budget a move.

Timing is pipelined as in ``bench.py``: move k+1 is dispatched before move
k's completion is proven by a device-to-host scalar. Before the warm-up the
CUDA kernels are built (their seconds on a ``#`` line of their own), so the
warm-up line covers what ``bench.py``'s does less the XLA compile. The
``#`` lines on stderr are ``bench.py``'s, and two more: the K1 and K2
launches of each timed move (``ops/tree_kernels.py:select_leaf_batched``,
``ops/scatter_kernels.py:write_rows``) and the peak memory over the timed
moves beside the card's name and power limit.

With ``dp > 1`` the games are split over ``dp`` ranks started on this host
(``cli/train.py``'s way: ``parallel/mesh.py:rank_device`` picks each
rank's device and the backend), each with ``batch / dp`` games and its own
generators. A barrier stands before the clock starts and after each
proven move; rank 0 prints the lines, with the rate taken as the global
batch times the moves over the wall time between barriers. Ranks that
share one card measure the path, not scaling.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.ops import _build, scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.device import card_line, resolve_device

# The reference fleet's self-play throughput (BASELINE.md: 113 actor
# processes on a 128-CPU + 8x RTX 3090 server), not a TPU figure.
BASELINE_ENV_STEPS_PER_S = 418.0
# Prefixes of the stderr lines that carry numbers as JSON.
LAUNCHES_PREFIX = "# K1/K2 launches a timed move, by rank: "
PEAK_PREFIX = "# peak memory over the timed moves, bytes by rank: "


@dataclasses.dataclass(frozen=True)
class Bench:
    """What one bench run plays, resolved from the config and the knobs."""

    cfg: config_lib.AlphaZeroConfig
    name: str                    # BENCH_CONFIG, as the metric names it
    batch: int                   # global games
    sims: int
    steps: int
    warmup: int
    reuse: bool
    max_new_sims: Optional[int]  # as bench.py reports it (set even with reuse off)
    dp: int                      # BENCH_DP as given (0 or 1: one process)
    search: config_lib.SearchConfig

    @property
    def loop_len(self) -> int:
        """NN-backed simulations a move: the simulation loop's length."""
        if not self.reuse or self.max_new_sims is None:
            return self.sims - 1
        return self.max_new_sims

    @property
    def metric(self) -> str:
        if self.name == "go9" and self.dp <= 1:
            return "selfplay_env_steps_per_s_9x9go_200sims"
        metric = f"selfplay_env_steps_per_s_{self.name}_{self.sims}sims"
        return metric + (f"_dp{self.dp}" if self.dp > 1 else "")

    def line(self, env_steps_per_s: float, partial: bool) -> dict:
        """One JSON line, keys in ``bench.py``'s order."""
        line = {
            "metric": self.metric,
            "value": round(env_steps_per_s, 1),
            "unit": "env-steps/s",
            "vs_baseline": round(env_steps_per_s / BASELINE_ENV_STEPS_PER_S, 3),
            "nn_sims_per_s": round(env_steps_per_s * self.loop_len),
            "budget_sims_per_s": round(env_steps_per_s * self.sims),
        }
        if partial:
            line["partial"] = True
        return line


class BenchResult(NamedTuple):
    lines: List[dict]                       # the JSON lines printed, in order
    launches: List[List[Tuple[int, int]]]   # [rank][timed move] -> (K1, K2)
    peak_bytes: List[Optional[int]]         # a rank's peak over the timed moves; None on the CPU
    moves: List[selfplay.StepOutput]        # each timed move's output, every rank's games, on the CPU
    legal: List[torch.Tensor]               # [B, A] legal moves of the games each timed move saw
    state: Optional[selfplay.SelfplayState]  # after the last move, on the device; None over ranks

    @property
    def last(self) -> selfplay.StepOutput:
        return self.moves[-1]

    @property
    def last_legal(self) -> torch.Tensor:
        return self.legal[-1]


def resolve(config_name: str = "go9", batch: Optional[int] = None,
            sims: Optional[int] = None, steps: int = 8, warmup: int = 1,
            reuse: Optional[bool] = None, max_new_sims: Optional[int] = None,
            dp: int = 0) -> Bench:
    """The run ``bench.py`` makes of these knobs; None takes the config's
    value (``max_new_sims`` only under reuse)."""
    cfg = config_lib.get_config(config_name)
    batch = cfg.parallel.selfplay_batch_size if batch is None else batch
    sims = cfg.search.num_simulations if sims is None else sims
    reuse = cfg.search.reuse_subtree if reuse is None else reuse
    if max_new_sims is None and reuse:
        max_new_sims = cfg.search.max_new_sims
    if steps < 1:
        raise ValueError(f"the bench needs at least one timed move, got steps={steps}")
    if dp > 1 and batch % dp != 0:
        raise SystemExit(f"BENCH_BATCH={batch} not divisible by BENCH_DP={dp}")
    search = dataclasses.replace(cfg.search, num_simulations=sims, reuse_subtree=reuse,
                                 max_new_sims=max_new_sims if reuse else None)
    return Bench(cfg, config_name, batch, sims, steps, warmup, reuse, max_new_sims, dp,
                 search)


def _note(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def _host(out: selfplay.StepOutput) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out._asdict().items()}


def _play(bench: Bench, dev: torch.device, params, noise, resign_u):
    """This process's share of the run: ``batch / world`` games, the
    warm-up, the timed moves. Rank 0 prints the lines. Returns this rank's
    record (numpy on the host) and its self-play state after the last
    move."""
    rank, world = multihost.rank(), multihost.world_size()
    lead = rank == 0
    local = bench.batch // world
    rows = slice(rank * local, (rank + 1) * local)
    cfg = bench.cfg
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device=dev, seed=0)
    if params is not None:
        net.load_state_dict(params_from_flax(params))
    step = selfplay.make_selfplay_step(engine, net, bench.search, cfg.resign, device=dev)
    init_gen = torch.Generator(device=dev).manual_seed(1 + 2 * rank)
    sp = selfplay.init_selfplay_state(
        engine, local, init_gen, resign_threshold=-1.0,
        disable_resign_ratio=cfg.resign.disable_resign_ratio,
        reuse_num_simulations=bench.sims if bench.reuse else None,
        resign_u=None if resign_u is None else resign_u[rows], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2 + 2 * rank)

    def move(sp, i):
        draws = None
        if noise is not None:
            draws = selfplay.SelfplayNoise(*(x[rows].to(dev) for x in noise[i]))
        return step(sp, gen, -1.0, noise=draws)

    if world > 1:
        devices = [None] * world
        dist.all_gather_object(devices, str(dev))
        if lead:
            backend = dist.get_backend()
            why = ("ranks share one device over gloo: this run measures the path, not "
                   "scaling" if backend == "gloo" else "a card a rank")
            _note(f"# dp={bench.dp} ranks on {devices}, backend {backend} ({why})")

    t_warm = time.perf_counter()
    for i in range(bench.warmup):
        sp, out = move(sp, i)
    if bench.warmup:
        # A device-to-host scalar proves the moves ran: it cannot be
        # acknowledged before the work it reads is done.
        _ = float(out.search_pi.sum())
    multihost.barrier()  # every rank warm before the clock starts
    if lead:
        _note(f"# warmup({bench.warmup} steps)={time.perf_counter() - t_warm:.1f}s")

    select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    lines, launches = [], []

    def emit(rate: float, partial: bool) -> None:
        line = bench.line(rate, partial)
        lines.append(line)
        print(json.dumps(line), flush=True)

    # Pipelined timing, as the training loop runs: dispatch move k+1, then
    # prove move k with a device-to-host scalar.
    # Each move's output and legal mask are fresh tensors that later moves
    # leave alone; they go to the host once the clock has stopped.
    t0 = time.perf_counter()
    outs, legal = [], []
    for i in range(bench.steps):
        k1, k2 = select.launches, writer.launches
        legal.append(sp.games.legal)
        sp, out = move(sp, bench.warmup + i)
        launches.append((select.launches - k1, writer.launches - k2))
        if outs:
            _ = float(outs[-1].search_pi.sum())
            multihost.barrier()
            rate = bench.batch * i / (time.perf_counter() - t0)
            if lead:
                emit(rate, partial=True)
                _note(f"# step {i}/{bench.steps}: {rate:,.0f} env-steps/s "
                      f"({rate * bench.loop_len:,.0f} NN sims/s, {rate * bench.sims:,.0f} "
                      f"budget sims/s)")
        outs.append(out)
    _ = float(outs[-1].search_pi.sum())
    multihost.barrier()
    elapsed = time.perf_counter() - t0
    rate = bench.batch * bench.steps / elapsed
    if lead:
        emit(rate, partial=False)
        _note(f"# config={bench.name} batch={bench.batch} sims={bench.sims} "
              f"reuse={bench.reuse} max_new_sims={bench.max_new_sims} dp={bench.dp or 1} "
              f"timed={elapsed:.2f}s for {bench.steps} steps; "
              f"nn_sims/s={rate * bench.loop_len:,.0f} "
              f"budget_sims/s={rate * bench.sims:,.0f}")
    return {"rank": rank, "lines": lines, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None,
            "moves": [_host(o) for o in outs], "legal": [x.cpu().numpy() for x in legal]}, sp


def _rank(rank: int, world: int, address: str, device: str, bench: Bench, params, noise,
          resign_u, results) -> None:
    """One spawned rank: joins the process group, plays its share, puts its
    record on ``results``."""
    dev = multihost.initialize(address, world, rank, device)
    try:
        results.put(_play(bench, dev, params, noise, resign_u)[0])
        multihost.barrier()
    finally:
        multihost.shutdown()


def run(config_name: str = "go9", batch: Optional[int] = None, sims: Optional[int] = None,
        steps: int = 8, warmup: int = 1, reuse: Optional[bool] = None,
        max_new_sims: Optional[int] = None, dp: int = 0, device="cuda",
        params: Optional[dict] = None,
        noise: Optional[Sequence[selfplay.SelfplayNoise]] = None,
        resign_u: Optional[torch.Tensor] = None) -> BenchResult:
    """The bench of ``config_name`` (``resolve``'s knobs) on ``device``.
    ``params`` are the net's Flax variables as numpy (``params_from_flax``)
    in place of the random weights of seed 0; ``noise[i]`` are move ``i``'s
    draws (warm-up moves first) and ``resign_u`` the initial games' resign
    uniforms, each over the global batch, in place of the generators'.
    Prints the lines and the ``#`` notes; returns what it printed, the
    launches, the peak memory, the timed moves and, in one process, the
    self-play state they left."""
    dev = resolve_device(device)
    bench = resolve(config_name, batch, sims, steps, warmup, reuse, max_new_sims, dp)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.build_all()  # before the warm-up, and before any rank loads the kernels
        _note(f"# built kernels {_build.sources()} in {time.perf_counter() - t0:.1f}s")
    state = None
    if dp > 1:
        records = multihost.spawn_and_collect(
            _rank, dp, (dp, multihost.local_address(), str(device), bench, params, noise,
                        resign_u))
    else:
        record, state = _play(bench, dev, params, noise, resign_u)
        records = [record]
    launches = [r["launches"] for r in records]
    peaks = [r["peak_bytes"] for r in records]
    _note(LAUNCHES_PREFIX + json.dumps(launches))
    if dev.type == "cuda":
        _note(PEAK_PREFIX + json.dumps(peaks) + " ("
              + ", ".join(f"{p / 2**30:.2f} GiB" for p in peaks) + f") on {card_line()}")
    else:
        _note(PEAK_PREFIX + json.dumps(peaks) + " (not measured on the CPU)")
    def joined(arrays):  # the ranks' games in rank order
        return torch.from_numpy(np.concatenate(arrays))

    moves = [selfplay.StepOutput(**{k: joined([r["moves"][i][k] for r in records])
                                    for k in selfplay.StepOutput._fields})
             for i in range(bench.steps)]
    legal = [joined([r["legal"][i] for r in records]) for i in range(bench.steps)]
    return BenchResult(records[0]["lines"], launches, peaks, moves, legal, state)


def knobs(environ) -> dict:
    """``run``'s arguments from ``bench.py``'s environment variables
    (``BENCH_CONFIG``, ``BENCH_BATCH``, ``BENCH_SIMS``, ``BENCH_STEPS``,
    ``BENCH_WARMUP``, ``BENCH_REUSE``, ``BENCH_MAX_NEW_SIMS``,
    ``BENCH_DP``) and ``BENCH_DEVICE``, the port's own (default
    ``cuda``). An unset or empty knob takes the config's value."""

    def knob(name, cast):
        value = environ.get(name, "")
        return cast(value) if value else None

    return dict(config_name=environ.get("BENCH_CONFIG", "go9"),
                batch=knob("BENCH_BATCH", int), sims=knob("BENCH_SIMS", int),
                steps=int(environ.get("BENCH_STEPS", "8")),
                warmup=int(environ.get("BENCH_WARMUP", "1")),
                reuse=knob("BENCH_REUSE", lambda v: bool(int(v))),
                max_new_sims=knob("BENCH_MAX_NEW_SIMS", int),
                dp=int(environ.get("BENCH_DP", "0")),
                device=environ.get("BENCH_DEVICE", "cuda"))


def main() -> BenchResult:
    """The bench as the environment says (``knobs``)."""
    return run(**knobs(os.environ))
