"""Config dataclasses — one CLI-friendly config replaces the reference's absl-flag training scripts.

Field values mirror the reference training scripts exactly:
- ``go9``       <- ``alpha_zero/training_go.py:31-199``        (9x9 Go, 10 blocks x 128 filters, 200 sims)
- ``go19_jumbo``<- ``alpha_zero/training_go_jumbo.py``          (19x19 Go, 19 x 256, 800 sims, AZ-paper lr 0.2)
- ``gomoku13``  <- ``alpha_zero/training_gomoku.py``            (13x13 freestyle Gomoku, 10 x 40, 380 sims)
- ``go19_b18c384nbt`` <- ``go19_jumbo`` with KataGo's ``b18c384nbt`` net (``models/nbt.py``)

TPU-specific knobs (``selfplay_batch_size``, ``mesh_*``) replace the reference's
process-count knobs (``num_actors``): the actor fleet becomes one batched,
jitted self-play program stepping thousands of games in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    game: str = "go"  # 'go' | 'gomoku'
    board_size: int = 9
    num_stack: int = 8
    komi: float = 7.5  # Go only
    num_to_win: int = 5  # Gomoku only
    max_steps: Optional[int] = None  # default: N*N*2 for Go, N*N for Gomoku

    @property
    def num_actions(self) -> int:
        n = self.board_size
        return n * n + 1 if self.game == "go" else n * n

    @property
    def has_pass_move(self) -> bool:
        return self.game == "go"

    @property
    def num_planes(self) -> int:
        return 2 * self.num_stack + 1

    def resolved_max_steps(self) -> int:
        if self.max_steps is not None:
            return self.max_steps
        n = self.board_size
        return n * n * 2 if self.game == "go" else n * n


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """The net ``models/resnet.py:build_network`` builds. ``architecture``
    "resnet" is the reference's ``AlphaZeroNet``: ``num_res_blocks`` basic
    blocks of ``num_filters`` channels, a value head of ``num_fc_units``.
    "nbt" is KataGo's nested-bottleneck net (``models/nbt.py``):
    ``num_res_blocks`` blocks on a ``num_filters`` trunk, each a 1x1 conv down
    to ``nbt_mid_channels``, two inner residual blocks and a 1x1 conv back;
    the first inner block of each block in ``nbt_gpool_blocks`` (1-based, comma
    separated) adds a bias pooled from ``nbt_gpool_channels`` channels; the
    heads have ``nbt_policy_channels``, ``nbt_policy_gpool_channels`` and
    ``nbt_value_channels``, the value head ``num_fc_units``. The ``nbt_*``
    defaults are KataGo's ``b18c384nbt`` and unused by the ResNet."""

    num_res_blocks: int = 10
    num_filters: int = 128
    num_fc_units: int = 128
    # Gomoku uses a padding-3 stem to fix edge blindness (reference network.py:100-105).
    gomoku: bool = False
    # TPU: bf16 matmuls on the MXU for self-play inference; fp32 master weights.
    inference_dtype: str = "bfloat16"
    architecture: str = "resnet"  # 'resnet' | 'nbt'
    nbt_mid_channels: int = 192
    nbt_gpool_channels: int = 64
    nbt_gpool_blocks: str = "3,6,9,12,15"
    nbt_policy_channels: int = 48
    nbt_policy_gpool_channels: int = 48
    nbt_value_channels: int = 96


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    num_simulations: int = 200
    c_puct_base: float = 19652.0
    c_puct_init: float = 1.25
    dirichlet_eps: float = 0.25
    dirichlet_alpha: float = 0.03
    warm_up_steps: int = 16
    # Temperatures for the visit-count policy (mcts_v2.py:265-298): the
    # effective exponent is clip(1/temp, 1, 5), so the reference defaults
    # (1.0 warm-up / 0.1 after) give exponents 1 and 5.
    warm_up_temperature: float = 1.0
    temperature: float = 0.1
    # Subtree reuse across moves (mcts_v2.py:643-653): promote the chosen
    # child's subtree to the root so carried visits count against the next
    # move's budget. ``max_new_sims`` caps the per-move simulation-loop
    # length (None = num_simulations - 1, enough for a fresh tree); with
    # reuse on, values below that trade worst-case budget completion for
    # wall-clock — the throughput lever reuse buys.
    reuse_subtree: bool = False
    max_new_sims: Optional[int] = None
    # Deviation from the reference's virtual-loss tree parallelism
    # (mcts_v2.py:568-625): the whole game batch advances synchronously, one
    # leaf per game per simulation, so virtual loss is unnecessary — NN eval
    # batching comes from the game batch instead of intra-tree leaves.


@dataclasses.dataclass(frozen=True)
class ResignConfig:
    init_resign_threshold: float = -0.88  # <= -1 disables resignation entirely
    check_resign_after_steps: int = 40
    target_fp_rate: float = 0.05
    disable_resign_ratio: float = 0.1
    reset_fp_interval: int = 100_000
    no_resign_games: int = 50_000

    @property
    def enabled(self) -> bool:
        return self.init_resign_threshold > -1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    min_games: int = 20_000
    games_per_ckpt: int = 5_000
    replay_capacity: int = 250_000 * 50
    batch_size: int = 1024
    argument_data: bool = True  # random dihedral augmentation (reference name kept)
    init_lr: float = 0.01
    lr_decay: float = 0.1
    lr_milestones: Tuple[int, ...] = (100_000, 200_000)
    l2_regularization: float = 1e-4
    sgd_momentum: float = 0.9
    max_training_steps: int = 500_000
    ckpt_interval: int = 1000
    log_interval: int = 200
    save_replay_interval: int = 0
    # Reference-exact generation fence (pipeline.py:492-493): discard games
    # that were in flight when the weights switched. Default keeps them —
    # their pre-switch transitions enter replay (see pipeline.py docstring).
    drop_straddling_games: bool = False


@dataclasses.dataclass(frozen=True)
class RunConfig:
    ckpt_dir: str = "./checkpoints/go/9x9"
    logs_dir: str = "./logs/go/9x9"
    eval_games_dir: str = ""
    save_sgf_dir: str = ""
    save_sgf_interval: int = 500
    load_ckpt: str = ""
    load_replay: str = ""
    log_level: str = "INFO"
    seed: int = 1
    default_rating: float = 0.0
    # Latest-vs-prev games per checkpoint. 1 = the reference-exact evaluator
    # (one deterministic game, latest as black, pipeline.py:814-867) — whose
    # Elo is komi/color noise at 1 sample. >1 = that many stochastic lockstep
    # games with alternating colors (eval/match.py player), Elo per game.
    eval_games: int = 16
    # Run evaluations on a background thread (the reference's concurrent
    # evaluator-process topology, training_go.py:292-314): the next
    # generation's self-play starts immediately after training instead of
    # waiting for the matches + pro-metrics pass. A crash loses queued
    # evaluations' csv rows (as the reference loses its evaluator process).
    eval_async: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """TPU parallelism. The reference's 'num_actors' process fleet
    (training_go.py:276-347) maps to `selfplay_batch_size` lockstep games on
    device; multi-chip scale-out shards games and the train batch over 'dp'
    and optionally the model over 'mdl'."""

    selfplay_batch_size: int = 1024  # games per HOST (multi-host: global = x processes)
    dp: int = 1  # data-parallel mesh axis (games + train batch sharded)
    mdl: int = 1  # model-parallel mesh axis (wide layers sharded)
    # Multi-host (jax.distributed): set the coordinator on every process to
    # form one global ('dp', 'mdl') mesh over all hosts' devices — replaces
    # the reference's single-machine mp.Process fleet (training_go.py:276-347).
    coordinator_address: str = ""  # "" = single host
    num_processes: int = 0         # 0 = from the coordinator
    process_id: int = -1           # -1 = auto
    # Multi-host generation-fence cadence: the cross-host game-count allgather
    # + threshold broadcast runs every this many self-play steps (per-step
    # fencing would gate the fleet on DCN control-plane latency; the
    # reference fences per finished game, pipeline.py:485-497).
    fence_interval: int = 8


@dataclasses.dataclass(frozen=True)
class AlphaZeroConfig:
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    resign: ResignConfig = dataclasses.field(default_factory=ResignConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)


def go9() -> AlphaZeroConfig:
    """9x9 Go trained config (reference training_go.py defaults).

    Subtree reuse is ON like the reference (mcts_v2.py:643-653 always
    re-roots); ``max_new_sims=120`` is the throughput lever reuse buys
    (bench: +38% env-steps/s vs reuse off) — strength tradeoff measured by
    head-to-head matches in PERF.md."""
    return AlphaZeroConfig(
        env=EnvConfig(game="go", board_size=9, komi=7.5, num_stack=8),
        network=NetworkConfig(num_res_blocks=10, num_filters=128, num_fc_units=128),
        search=SearchConfig(num_simulations=200, warm_up_steps=16,
                            reuse_subtree=True, max_new_sims=120),
        resign=ResignConfig(),
        train=TrainConfig(),
        run=RunConfig(ckpt_dir="./checkpoints/go/9x9", logs_dir="./logs/go/9x9"),
    )


def go19_jumbo() -> AlphaZeroConfig:
    """19x19 Go jumbo config (reference training_go_jumbo.py deltas)."""
    return AlphaZeroConfig(
        env=EnvConfig(game="go", board_size=19, komi=7.5, num_stack=8),
        network=NetworkConfig(num_res_blocks=19, num_filters=256, num_fc_units=256),
        search=SearchConfig(num_simulations=800, warm_up_steps=30,
                            reuse_subtree=True, max_new_sims=480),
        resign=ResignConfig(check_resign_after_steps=80),
        train=TrainConfig(
            min_games=50_000,
            games_per_ckpt=25_000,
            replay_capacity=500_000 * 100,
            batch_size=2048,
            init_lr=0.2,
            lr_milestones=(200_000, 400_000, 600_000),
            max_training_steps=700_000,
        ),
        run=RunConfig(ckpt_dir="./checkpoints/go/19x19", logs_dir="./logs/go/19x19"),
        parallel=ParallelConfig(selfplay_batch_size=2048),
    )


def go19_b18c384nbt() -> AlphaZeroConfig:
    """``go19_jumbo``'s game, search, resignation, training and batch with
    KataGo's ``b18c384nbt`` net (lightvector/KataGo
    ``python/katago/train/modelconfigs.py``): 18 nested-bottleneck blocks on
    a 384 trunk, 192 mid channels, 64 pooled channels, bf16 inference."""
    cfg = go19_jumbo()
    return dataclasses.replace(
        cfg,
        network=NetworkConfig(architecture="nbt", num_res_blocks=18, num_filters=384,
                              num_fc_units=128),
        run=RunConfig(ckpt_dir="./checkpoints/go/19x19_b18c384nbt",
                      logs_dir="./logs/go/19x19_b18c384nbt"),
    )


def gomoku13() -> AlphaZeroConfig:
    """13x13 freestyle Gomoku config (reference training_gomoku.py defaults)."""
    return AlphaZeroConfig(
        env=EnvConfig(game="gomoku", board_size=13, num_stack=8, num_to_win=5),
        network=NetworkConfig(num_res_blocks=10, num_filters=40, num_fc_units=80, gomoku=True),
        # Reuse on (reference always re-roots). max_new_sims=240 mirrors
        # go9's 120/200 cap ratio (~0.63): +68% env-steps/s measured
        # (PERF.md), and the cap measured strength-positive head-to-head at
        # both other configs (go9 random-weights 184/256, gomoku9 trained
        # ckpt 149/256). Set max_new_sims=None for the uncapped reference
        # budget.
        search=SearchConfig(num_simulations=380, warm_up_steps=16,
                            reuse_subtree=True, max_new_sims=240),
        resign=ResignConfig(init_resign_threshold=-1.0, check_resign_after_steps=0,
                            target_fp_rate=0.0, disable_resign_ratio=0.0,
                            reset_fp_interval=0, no_resign_games=0),
        train=TrainConfig(min_games=5_000, replay_capacity=150_000 * 10, batch_size=256),
        run=RunConfig(ckpt_dir="./checkpoints/gomoku/13x13", logs_dir="./logs/gomoku/13x13"),
    )


def gomoku9() -> AlphaZeroConfig:
    """Small-rig 9x9 Gomoku (reference README.md:148 guidance)."""
    cfg = gomoku13()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, board_size=9),
        run=RunConfig(ckpt_dir="./checkpoints/gomoku/9x9", logs_dir="./logs/gomoku/9x9"),
    )


CONFIGS = {
    "go9": go9,
    "go19_jumbo": go19_jumbo,
    "go19_b18c384nbt": go19_b18c384nbt,
    "gomoku13": gomoku13,
    "gomoku9": gomoku9,
}


def get_config(name: str) -> AlphaZeroConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}', available: {sorted(CONFIGS)}")
    return CONFIGS[name]()
