"""Head-to-head matches: G games in lockstep on the device.

The port of ``alpha_zero_tpu.eval.match``. Both sides sample from the
visit-count policy without root noise. Every move (a pass included) flips
the player to move and finished games idle, so all games share move
parity and each ply evaluates one net for the whole batch: black's on even
plies, white's on odd. A game that ends waits for the others; the ply loop
stops when every game is done, or after ``engine.max_steps + 2`` plies.

Each side is an ``nn.Module`` in eval mode on the games' device; a match
never copies weights between plies. The sampling draws are an input:
``draws(ply) -> gumbel f32[G, A]`` (the tests pass the JAX package's), by
default drawn from a ``torch.Generator`` on the device seeded with
``seed``.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable, Dict, List, Optional

import torch

from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.training.selfplay import make_eval_fn
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.results import result_string

PlayerMove = namedtuple("PlayerMove", ["color", "move"])

Draws = Callable[[int], torch.Tensor]


def default_draws(engine, num_games: int, seed: int, device) -> Draws:
    """Gumbel draws from a generator on ``device`` seeded with ``seed``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return lambda ply: mcts.gumbel_draw(generator, (num_games, engine.num_actions), device)


def _sample(engine, result: mcts.SearchResult, gumbel: torch.Tensor) -> torch.Tensor:
    """A move sampled from the visit-count policy (no warm-up in matches)."""
    warm = torch.zeros(result.legal.shape[0], dtype=torch.bool, device=result.legal.device)
    pi = mcts.policy_from_counts(result.child_N, result.legal, warm)
    return mcts.sample_move(
        gumbel, pi, result.legal, result.child_N, warm,
        pass_move=engine.pass_move if engine.has_pass_move else None,
        deterministic=False)


def make_match_move_fn(engine, search_cfg) -> Callable:
    """``move_fn(net, states, gumbel) -> (new_states, move)``: a fresh-tree
    search without noise, a sampled move, the step. Finished games step as
    no-ops."""

    def move_fn(net, states, gumbel):
        result = mcts.batched_search(
            make_eval_fn(net), engine, states,
            num_simulations=search_cfg.num_simulations,
            c_puct_base=search_cfg.c_puct_base,
            c_puct_init=search_cfg.c_puct_init,
            root_noise=False,
        )
        move = _sample(engine, result, gumbel)
        return engine.step_batch(states, move), move

    return move_fn


def make_match_move_fn_reuse(engine, search_cfg) -> Callable:
    """``move_fn(net, states, my_trees, opp_trees, gumbel) -> (new_states,
    move, my_trees, opp_trees)``: the mover's carried trees seed the search
    (which takes them over), and the played move re-roots both the mover's
    and the opponent's trees."""

    def move_fn(net, states, my_trees, opp_trees, gumbel):
        result, trees = mcts.batched_search(
            make_eval_fn(net), engine, states,
            num_simulations=search_cfg.num_simulations,
            c_puct_base=search_cfg.c_puct_base,
            c_puct_init=search_cfg.c_puct_init,
            root_noise=False,
            prev_trees=my_trees,
            max_new_sims=search_cfg.max_new_sims,
            return_trees=True,
        )
        move = _sample(engine, result, gumbel)
        new_states = engine.step_batch(states, move)
        move_eff = torch.where(states.done, -1, move)
        my_new = mcts.reroot_trees(trees, move_eff, new_states.done, new_states,
                                   engine.num_actions)
        opp_new = mcts.reroot_trees(opp_trees, move_eff, new_states.done, new_states,
                                    engine.num_actions)
        return new_states, move, my_new, opp_new

    return move_fn


def _record(all_moves, was_done, move, color) -> None:
    done, mv = was_done.cpu().tolist(), move.cpu().tolist()
    for i, moves in enumerate(all_moves):
        if not done[i] and mv[i] >= 0:
            moves.append(PlayerMove(color, int(mv[i])))


def play_matches_asym(engine, black_cfg, white_cfg, black_net, white_net,
                      num_games: int, seed: int = 0, record_moves: bool = False,
                      draws: Optional[Draws] = None, device="cuda") -> List[Dict]:
    """Head-to-head with a search config per side (e.g. black reusing
    subtrees at ``max_new_sims`` against white's fresh full budget). When
    either side reuses, both carry a tree per game and every ply re-roots
    both; a side with ``reuse_subtree=False`` still searches fresh trees."""
    fns, trees = {}, {}
    for color, cfg in (("B", black_cfg), ("W", white_cfg)):
        fns[color] = (make_match_move_fn_reuse(engine, cfg) if cfg.reuse_subtree
                      else make_match_move_fn(engine, cfg))
    states = engine.init_batch(num_games, device=device)
    if black_cfg.reuse_subtree or white_cfg.reuse_subtree:
        for color, cfg in (("B", black_cfg), ("W", white_cfg)):
            trees[color] = mcts.make_empty_trees(engine, states, cfg.num_simulations)
    draws = draws or default_draws(engine, num_games, seed, states.board.device)
    all_moves: List[List[PlayerMove]] = [[] for _ in range(num_games)]

    ply = 0
    while not bool(states.done.all()):
        color, other = ("B", "W") if ply % 2 == 0 else ("W", "B")
        cfg = black_cfg if color == "B" else white_cfg
        net = black_net if color == "B" else white_net
        was_done = states.done
        if cfg.reuse_subtree:
            states, move, trees[color], trees[other] = fns[color](
                net, states, trees[color], trees[other], draws(ply))
        else:
            states, move = fns[color](net, states, draws(ply))
            if other in trees:
                # Re-root the reusing side's trees through this ply too.
                move_eff = torch.where(was_done, -1, move)
                trees[other] = mcts.reroot_trees(trees[other], move_eff, states.done,
                                                 states, engine.num_actions)
        if record_moves:
            _record(all_moves, was_done, move, color)
        ply += 1
        if ply > engine.max_steps + 2:
            break

    return collect_stats(states, all_moves if record_moves else None)


def collect_stats(states, all_moves=None) -> List[Dict]:
    """Per-game stats dicts: game, game_result, game_length, winner, and the
    moves when recorded."""
    winners = states.winner.cpu().tolist()
    resigned = states.resigned.cpu().tolist()
    scores = states.final_score.cpu().tolist()
    lengths = states.step_count.cpu().tolist()
    out = []
    for i in range(len(winners)):
        stats = {
            "game": i,
            "game_result": result_string(int(winners[i]), float(scores[i]), bool(resigned[i])),
            "game_length": int(lengths[i]),
            "winner": int(winners[i]),
        }
        if all_moves is not None:
            stats["moves"] = all_moves[i]
        out.append(stats)
    return out


def play_lockstep(engine, move_fn, black_net, white_net, num_games: int,
                  draws: Draws, device, record_moves: bool = False):
    """``num_games`` lockstep games through ``move_fn`` (black's net on even
    plies). Returns the final states and, when ``record_moves``, every
    game's moves."""
    states = engine.init_batch(num_games, device=device)
    all_moves: List[List[PlayerMove]] = [[] for _ in range(num_games)]
    ply = 0
    while not bool(states.done.all()):
        net, color = (black_net, "B") if ply % 2 == 0 else (white_net, "W")
        was_done = states.done
        states, move = move_fn(net, states, draws(ply))
        if record_moves:
            _record(all_moves, was_done, move, color)
        ply += 1
        if ply > engine.max_steps + 2:
            break
    return states, all_moves


def play_matches(engine, search_cfg, black_net, white_net, num_games: int,
                 seed: int = 0, record_moves: bool = False,
                 draws: Optional[Draws] = None, device="cuda") -> List[Dict]:
    """Plays ``num_games`` lockstep games; returns per-game stats dicts."""
    device = resolve_device(device)
    states, all_moves = play_lockstep(
        engine, make_match_move_fn(engine, search_cfg), black_net, white_net,
        num_games, draws or default_draws(engine, num_games, seed, device), device,
        record_moves)
    return collect_stats(states, all_moves if record_moves else None)
