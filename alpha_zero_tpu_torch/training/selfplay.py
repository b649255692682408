"""Batched self-play on the device.

The port of ``alpha_zero_tpu.training.selfplay``: one call steps every game
of the batch by one move,

    selfplay_step:  batched MCTS  ->  temperature policy  ->  move sampling
                    -> resignation logic -> batched engine step -> auto-reset

and emits one transition per game; the host accumulates per-game episodes
(``EpisodeAccumulator``) and finalizes them with their z-targets when games
complete. A finished game's slot restarts in place, so the batch never idles.

Resignation: per-game resign-disabled flags are drawn at game start with
probability ``disable_resign_ratio``; a game is "marked" the first time both
root Q and best-child Q fall below the threshold after
``check_resign_after_steps``; marked games with resignation enabled resign,
disabled ones play on to measure false positives.

Randomness: a step uses three draws, ``SelfplayNoise``. The caller may pass
them (the tests pass the JAX package's draws); otherwise the step draws them
from its ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from alpha_zero_tpu_torch.envs.types import RESIGN, GameState
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.utils import trace
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.results import result_string


@dataclasses.dataclass
class SelfplayState:
    """Batched device state carried across self-play steps."""

    games: GameState                      # [B] live games (never done on entry)
    resign_disabled: torch.Tensor         # bool[B]
    marked_resign_player: torch.Tensor    # int8[B]; 0 = unmarked
    trees: Optional[mcts.Tree] = None     # [B] carried search trees (reuse)


class SelfplayNoise(NamedTuple):
    """The random draws of one self-play step."""

    dirichlet: torch.Tensor  # f32[B, A] root noise, one Dirichlet draw per game
    gumbel: torch.Tensor     # f32[B, A] move-sampling noise
    resign_u: torch.Tensor   # f32[B] uniforms for the reset games' resign flags


class StepOutput(NamedTuple):
    """Per-move record for every game slot (the host copies these out)."""

    obs: torch.Tensor           # [B, N, N] int32 root observation, plane c in
    #                             bit c (EpisodeAccumulator unpacks it)
    search_pi: torch.Tensor     # [B, A] f32
    to_play: torch.Tensor       # [B] i8 (player who chose the move)
    move: torch.Tensor          # [B] i32 (RESIGN == -1)
    root_q: torch.Tensor        # [B] f32
    best_child_q: torch.Tensor  # [B] f32
    root_visits: torch.Tensor   # [B] f32; root N when the budget ended
    # Game-completion info (valid where done):
    done: torch.Tensor          # [B] bool
    winner: torch.Tensor        # [B] i8
    resigned: torch.Tensor      # [B] bool
    final_score: torch.Tensor   # [B] f32
    game_length: torch.Tensor   # [B] i32
    num_passes: torch.Tensor    # [B] i32
    was_resign_disabled: torch.Tensor   # [B] bool
    marked_resign_player: torch.Tensor  # [B] i8


def _sample_resign_disabled(u: torch.Tensor, has_resign: bool,
                            threshold: float, ratio: float) -> torch.Tensor:
    """Resign is enabled (disabled=False) iff the env supports it, the
    threshold is active and the uniform draw ``u [B]`` exceeds ``ratio``."""
    if not has_resign:
        return torch.ones_like(u, dtype=torch.bool)
    return ~((threshold > -1.0) & (u > ratio))


def init_selfplay_state(engine, batch_size: int,
                        generator: Optional[torch.Generator],
                        resign_threshold: float, disable_resign_ratio: float,
                        reuse_num_simulations: Optional[int] = None,
                        resign_u: Optional[torch.Tensor] = None,
                        device="cuda") -> SelfplayState:
    """Fresh games on ``device``. ``resign_u [B]`` are the uniforms for the
    resign-disabled flags (drawn from ``generator`` when absent).
    ``reuse_num_simulations`` (the search budget) must be set when the step
    reuses subtrees: it sizes the carried trees."""
    dev = resolve_device(device)
    games = engine.init_batch(batch_size, device=dev)
    if resign_u is None:
        resign_u = torch.rand((batch_size,), generator=generator, device=dev)
    trees = None
    if reuse_num_simulations is not None:
        trees = mcts.make_empty_trees(engine, games, reuse_num_simulations)
    return SelfplayState(
        games=games,
        resign_disabled=_sample_resign_disabled(
            resign_u.to(dev), engine.has_resign_move, resign_threshold,
            disable_resign_ratio),
        marked_resign_player=torch.zeros((batch_size,), dtype=torch.int8,
                                         device=dev),
        trees=trees,
    )


def make_eval_fn(net) -> Callable:
    """The search's evaluation function for ``net``: obs -> (softmax policy
    in float32 [B, A], value [B])."""

    def eval_fn(obs: torch.Tensor):
        with trace.span("net"), torch.no_grad():
            out = net(obs)
            return F.softmax(out.pi_logits.float(), dim=-1), out.value

    return eval_fn


def make_selfplay_step(engine, net, search_cfg, resign_cfg,
                       deterministic: bool = False, root_noise: bool = True,
                       device="cuda") -> Callable:
    """Builds the self-play step for ``net`` (an ``nn.Module`` in eval mode
    on ``device``; its weights are read at every call).

    Returns ``step(sp_state, generator=None, resign_threshold=-1.0,
    noise=None) -> (new_sp_state, StepOutput)``. ``resign_threshold`` is the
    host-controlled threshold; ``noise`` a ``SelfplayNoise``, drawn from
    ``generator`` when absent. The step updates ``sp_state.trees`` in place
    and hands them on in the new state."""
    dev = resolve_device(device)
    has_pass = engine.has_pass_move
    pass_move = engine.pass_move if has_pass else None
    has_resign = engine.has_resign_move
    num_actions = engine.num_actions
    warm_up_steps = search_cfg.warm_up_steps
    check_after = resign_cfg.check_resign_after_steps
    disable_ratio = resign_cfg.disable_resign_ratio
    reuse = getattr(search_cfg, "reuse_subtree", False)
    max_new_sims = getattr(search_cfg, "max_new_sims", None)
    if max_new_sims is not None and not reuse:
        # Without reuse every tree is fresh and needs the full
        # num_simulations - 1 loop; a smaller cap would silently truncate
        # every search below budget and skew the visit-count policy.
        raise ValueError(
            "search.max_new_sims requires search.reuse_subtree=True "
            f"(got max_new_sims={max_new_sims} with reuse off)")
    warm_temp = getattr(search_cfg, "warm_up_temperature", 1.0)
    final_temp = getattr(search_cfg, "temperature", 0.1)

    eval_fn = make_eval_fn(net)

    def selfplay_step(sp: SelfplayState, generator: Optional[torch.Generator] = None,
                      resign_threshold: float = -1.0,
                      noise: Optional[SelfplayNoise] = None):
        with trace.span("selfplay.step"):
            return step(sp, generator, resign_threshold, noise)

    def step(sp, generator, resign_threshold, noise):
        games = sp.games
        batch = games.done.shape[0]
        if noise is None:
            noise = SelfplayNoise(
                dirichlet=mcts.dirichlet_draw(generator, batch, num_actions,
                                              search_cfg.dirichlet_alpha, dev),
                gumbel=mcts.gumbel_draw(generator, (batch, num_actions), dev),
                resign_u=torch.rand((batch,), generator=generator, device=dev))

        obs = engine.observation(games)
        search_out = mcts.batched_search(
            eval_fn, engine, games,
            num_simulations=search_cfg.num_simulations,
            c_puct_base=search_cfg.c_puct_base,
            c_puct_init=search_cfg.c_puct_init,
            root_noise=root_noise,
            dirichlet_eps=search_cfg.dirichlet_eps,
            dirichlet_noise=noise.dirichlet,
            prev_trees=sp.trees if reuse else None,
            max_new_sims=max_new_sims,
            return_trees=reuse,
        )
        result, trees = search_out if reuse else (search_out, None)

        with trace.span("selfplay.policy_sample"):
            warm_up = games.step_count <= warm_up_steps
            search_pi = mcts.policy_from_counts(
                result.child_N, result.legal, warm_up,
                warm_up_temperature=warm_temp, temperature=final_temp)
            move = mcts.sample_move(noise.gumbel, search_pi, result.legal,
                                    result.child_N, warm_up, pass_move=pass_move,
                                    deterministic=deterministic)
            best_q = mcts.best_child_q(result.child_N, result.child_W, move)

            marked = sp.marked_resign_player
            if has_resign and resign_threshold > -1.0:
                signal = ((games.step_count > check_after)
                          & (result.root_Q < resign_threshold)
                          & (best_q < resign_threshold))
                newly_marked = signal & (marked == 0)
                marked = torch.where(newly_marked, games.to_play, marked)
                move = torch.where(signal & ~sp.resign_disabled, RESIGN, move)

        with trace.span("go.step"):
            stepped = engine.step_batch(games, move)
        done = stepped.done

        # Bit-pack the binary observation planes (plane c -> bit c).
        plane_bits = 2 ** torch.arange(obs.shape[-1], dtype=torch.int32, device=dev)
        obs_packed = (obs.to(torch.int32) * plane_bits).sum(dim=-1, dtype=torch.int32)

        out = StepOutput(
            obs=obs_packed,
            search_pi=search_pi,
            to_play=games.to_play,
            move=move,
            root_q=result.root_Q,
            best_child_q=best_q,
            root_visits=1.0 + result.child_N.sum(dim=-1),
            done=done,
            winner=stepped.winner,
            resigned=stepped.resigned,
            final_score=stepped.final_score,
            game_length=stepped.step_count,
            num_passes=stepped.num_passes,
            was_resign_disabled=sp.resign_disabled,
            marked_resign_player=marked,
        )

        with trace.span("selfplay.reset"):
            # Auto-reset finished slots; redraw their resign-disabled flags.
            fresh = engine.init_batch(batch, device=dev)
            new_games = fresh.map2(stepped, lambda f, s: torch.where(
                done.reshape((batch,) + (1,) * (s.dim() - 1)), f, s))
            new_disabled = _sample_resign_disabled(
                noise.resign_u, has_resign, resign_threshold, disable_ratio)
        new_trees = None
        if reuse:
            with trace.span("search.reroot"):
                # The chosen child's subtree becomes the next root; finished
                # (auto-reset) games get fresh trees.
                new_trees = mcts.reroot_trees(trees, move, done, new_games, num_actions)
        new_sp = SelfplayState(
            games=new_games,
            resign_disabled=torch.where(done, new_disabled, sp.resign_disabled),
            marked_resign_player=torch.where(done, 0, marked).to(torch.int8),
            trees=new_trees,
        )
        return new_sp, out

    return selfplay_step


# ---------------------------------------------------------------------------
# Host-side episode accumulation
# ---------------------------------------------------------------------------


class FinishedGame(NamedTuple):
    """One completed game, on the host."""

    states: np.ndarray     # [L, N, N, C] int8
    pi_probs: np.ndarray   # [L, A] f32
    values: np.ndarray     # [L] f32 z-targets
    stats: dict
    moves: list            # [(color 'B'/'W', flat move)] excluding resign — for SGF


class EpisodeAccumulator:
    """Collects per-slot transitions; emits finished games with z-targets:
    all zero on draws, else +1 for steps whose to-play player won, -1
    otherwise."""

    def __init__(self, batch_size: int, num_planes: Optional[int] = None) -> None:
        self.batch_size = batch_size
        self.num_planes = num_planes  # needed to unpack bit-packed obs
        self._obs: list[list[np.ndarray]] = [[] for _ in range(batch_size)]
        self._pi: list[list[np.ndarray]] = [[] for _ in range(batch_size)]
        self._to_play: list[list[int]] = [[] for _ in range(batch_size)]
        self._moves: list[list] = [[] for _ in range(batch_size)]
        self._stale = np.zeros(batch_size, np.bool_)

    def mark_all_stale(self) -> None:
        """Flags every in-flight game as started under now-replaced weights
        (``stats['stale']``); empty slots are not in flight and stay clean."""
        for i in range(self.batch_size):
            self._stale[i] = bool(self._obs[i])

    def add_step(self, out: StepOutput) -> list[FinishedGame]:
        out = StepOutput(*(np.asarray(x.detach().cpu()) for x in out))
        obs = out.obs
        if obs.ndim == 3:
            # Bit-packed planes from make_selfplay_step; unpack on host.
            if self.num_planes is None:
                raise ValueError(
                    "bit-packed obs needs EpisodeAccumulator(num_planes=...)")
            obs = ((obs[..., None] >> np.arange(self.num_planes, dtype=np.int32))
                   & 1).astype(np.int8)
        pi = out.search_pi
        to_play = out.to_play.tolist()
        move = out.move.tolist()
        done_idx = np.flatnonzero(out.done)

        finished: list[FinishedGame] = []
        for i in range(self.batch_size):
            # The final (even resigning) step's transition is recorded;
            # resign moves are left out of the SGF move history only.
            self._obs[i].append(obs[i])
            self._pi[i].append(pi[i])
            self._to_play[i].append(to_play[i])
            if move[i] != RESIGN:
                color = "B" if to_play[i] == 1 else "W"
                self._moves[i].append((color, move[i]))
        for i in done_idx:
            finished.append(self._finalize(int(i), out, i_winner=int(out.winner[i])))
        return finished

    def _finalize(self, i: int, out: StepOutput, i_winner: int) -> FinishedGame:
        states = np.stack(self._obs[i])
        pis = np.stack(self._pi[i])
        to_plays = np.asarray(self._to_play[i], np.int8)
        if i_winner == 0:
            values = np.zeros(len(to_plays), np.float32)
        else:
            values = np.where(to_plays == i_winner, 1.0, -1.0).astype(np.float32)

        marked = int(out.marked_resign_player[i])
        was_disabled = bool(out.was_resign_disabled[i])
        is_marked = was_disabled and marked != 0
        resigned = bool(out.resigned[i])
        stats = {
            "game_length": int(out.game_length[i]),
            "game_result": result_string(i_winner, float(out.final_score[i]), resigned),
            "num_passes": int(out.num_passes[i]),
            "is_resign_disabled": was_disabled,
            "is_marked_for_resign": is_marked,
            "is_could_won": is_marked and i_winner == marked,
            "marked_resign_player": {1: "B", -1: "W", 0: None}[marked],
            "winner": i_winner,
            "stale": bool(self._stale[i]),
        }
        self._stale[i] = False

        moves = list(self._moves[i])
        self._obs[i].clear()
        self._pi[i].clear()
        self._to_play[i].clear()
        self._moves[i].clear()
        return FinishedGame(states=states, pi_probs=pis, values=values,
                            stats=stats, moves=moves)
