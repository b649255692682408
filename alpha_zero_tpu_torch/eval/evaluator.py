"""Evaluator: latest-vs-previous matches with Elo, and pro-game metrics.

The port of ``alpha_zero_tpu.eval.evaluator``:

- ``eval_against_prev_ckpt``: one deterministic game, black = the latest
  checkpoint, white = the previous one, no root noise, an Elo update for
  both players. The Evaluator plays it when ``eval_games=1``; with
  ``eval_games=N`` it plays N stochastic lockstep games per checkpoint
  (``eval/match.py``), half with the latest net as black, and updates Elo
  per game.
- ``eval_on_pro_games``: top-1/3/5 human-move accuracy, policy entropy and
  value MSE over the pro-game dataset. Top-k breaks ties toward the lower
  action, as ``jax.lax.top_k`` does.

Nets are ``nn.Module``s in eval mode. The Evaluator holds one per side in
the inference dtype (BatchNorm float32, ``to_inference_dtype``) and takes
the checkpoints as ``state_dict``s; promoting the latest net to the
previous one swaps the two modules.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from alpha_zero_tpu_torch.envs.types import BLACK
from alpha_zero_tpu_torch.eval import match as match_lib
from alpha_zero_tpu_torch.eval.dataset import EvalDataset
from alpha_zero_tpu_torch.eval.elo import EloRating
from alpha_zero_tpu_torch.models.resnet import to_inference_dtype
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.training.selfplay import make_eval_fn
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.results import result_string

K_LIST = (1, 3, 5)


def make_eval_move_fn(engine, search_cfg) -> Callable:
    """``move_fn(net, state) -> (new_state, move)`` for one game (a batch of
    1): a search without noise and the most visited move (the first of
    equal counts)."""

    def move_fn(net, state):
        result = mcts.batched_search(
            make_eval_fn(net), engine, state,
            num_simulations=search_cfg.num_simulations,
            c_puct_base=search_cfg.c_puct_base,
            c_puct_init=search_cfg.c_puct_init,
            root_noise=False,
        )
        move = torch.argmax(result.child_N, dim=-1).to(torch.int32)
        return engine.step_batch(state, move), move[0]

    return move_fn


def play_eval_game(engine, move_fn, black_net, white_net, device="cuda") -> Dict:
    """One deterministic game: black plays ``black_net``."""
    state = engine.init(resolve_device(device))
    num_passes = 0
    moves = []
    while not bool(state.done[0]):
        black_to_play = int(state.to_play[0]) == BLACK
        net = black_net if black_to_play else white_net
        state, move = move_fn(net, state)
        move = int(move)
        moves.append(match_lib.PlayerMove("B" if black_to_play else "W", move))
        if engine.has_pass_move and move == engine.pass_move:
            num_passes += 1

    winner = int(state.winner[0])
    result = result_string(winner, float(state.final_score[0]), bool(state.resigned[0]))
    stats = {
        "game_length": int(state.step_count[0]),
        "game_result": result,
        "winner": winner,
        "moves": moves,
    }
    if engine.has_pass_move:
        stats["num_passes"] = num_passes
    return stats


def _update_elo(winner_elo: EloRating, loser_elo: EloRating) -> None:
    """The winner's update first, then the loser's against the new rating."""
    winner_elo.update_rating(loser_elo.rating, 1)
    loser_elo.update_rating(winner_elo.rating, 0)


def eval_against_prev_ckpt(engine, move_fn, black_net, white_net,
                           black_elo: EloRating, white_elo: EloRating,
                           device="cuda") -> Dict:
    """One deterministic game and the Elo update of both players."""
    stats = play_eval_game(engine, move_fn, black_net, white_net, device)
    winner = stats.pop("winner")
    moves = stats.pop("moves")
    if winner != 0:
        if winner == BLACK:
            _update_elo(black_elo, white_elo)
        else:
            _update_elo(white_elo, black_elo)
    stats["black_elo_rating"] = black_elo.rating
    stats["white_elo_rating"] = white_elo.rating
    stats["_moves"] = moves
    return stats


def topk_lower_index_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row, ties in index
    order (``jax.lax.top_k``'s order; ``torch.topk`` leaves it open)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]


def pro_metrics(net, states, target_pi, target_v, k_list=K_LIST):
    """One batch: (top-k hit counts {k: int64 tensor}, summed policy
    entropy, summed value squared error), on the batch's device."""
    with torch.no_grad():
        out = net(states)
    probs = F.softmax(out.pi_logits, dim=-1)
    target_idx = torch.argmax(target_pi, dim=-1)
    hits = topk_lower_index_first(probs, max(k_list)) == target_idx[:, None]
    correct = {k: hits[:, :k].any(dim=-1).sum() for k in k_list}
    entropy = -(probs * torch.log(torch.clamp_min(probs, 1e-12))).sum(dim=-1).sum()
    mse = torch.square(out.value - target_v).sum()
    return correct, entropy, mse


def _metrics_over(net, batches, m: int, k_list=K_LIST) -> Dict:
    total_correct = {k: 0 for k in k_list}
    total_entropy = 0.0
    total_mse = 0.0
    for states, pi, v in batches:
        correct, entropy, mse = pro_metrics(net, states, pi, v, k_list)
        for k in k_list:
            total_correct[k] += int(correct[k])
        total_entropy += float(entropy)
        total_mse += float(mse)
    stats = {
        "value_mse_error": total_mse / m,
        "policy_entropy": total_entropy / m,
    }
    for k in k_list:
        stats[f"policy_top_{k}_accuracy"] = total_correct[k] / m
    return stats


def eval_on_pro_games(net, dataset: EvalDataset, batch_size: int = 1024,
                      k_list=K_LIST, device="cuda") -> Dict:
    """Streams the dataset through ``pro_metrics`` in batches."""
    dev = resolve_device(device)
    m = len(dataset)
    if m == 0:
        return {}

    def batches():
        for start in range(0, m, batch_size):
            end = min(start + batch_size, m)
            yield tuple(torch.from_numpy(x[start:end]).to(dev) for x in (
                dataset.states, dataset.target_pi, dataset.target_v))

    return _metrics_over(net, batches(), m, k_list)


class Evaluator:
    """Holds the previous checkpoint's net and the Elo state across
    generations.

    ``eval_games=1`` plays one deterministic game, the latest net always
    black. ``eval_games=N`` plays N stochastic lockstep games per
    checkpoint, (N + 1) // 2 with the latest net as black and the rest as
    white, updating Elo once per finished game. ``draws(seed, ply, n) ->
    gumbel f32[n, A]`` supplies the sampling draws of those games (the
    tests pass the JAX package's); by default each batch of games draws
    from a generator on ``device`` seeded with its seed."""

    def __init__(self, engine, net, search_cfg, inference_dtype: str = "float32",
                 default_rating: float = 0.0, dataset: Optional[EvalDataset] = None,
                 eval_games: int = 1, device="cuda",
                 draws: Optional[Callable[[int, int, int], torch.Tensor]] = None) -> None:
        self.engine = engine
        self.device = resolve_device(device)
        self.eval_games = max(1, int(eval_games))
        self.move_fn = make_eval_move_fn(engine, search_cfg)
        self.batch_move_fn = match_lib.make_match_move_fn(engine, search_cfg)
        self.draws = draws
        # The latest and the previous checkpoint's nets.
        self.latest_net, self.prev_net = (
            to_inference_dtype(copy.deepcopy(net).to(self.device), inference_dtype).eval()
            for _ in range(2))
        self.has_prev = False
        self.black_elo = EloRating(rating=default_rating)
        self.white_elo = EloRating(rating=default_rating)
        self.dataset = dataset
        self._dataset_dev = None  # the dataset on the device, put there once

    def restore_continuity(self, rating: float, prev_weights=None) -> None:
        """Resume: carries the Elo history and, given its ``state_dict``, the
        previous model across a restart. After every ``evaluate`` both sides
        hold the same (promoted) rating, so one scalar restores the pair."""
        self.black_elo = EloRating(rating=rating)
        self.white_elo = EloRating(rating=rating)
        if prev_weights is not None:
            self.prev_net.load_state_dict(prev_weights)
            self.has_prev = True

    def evaluate(self, weights, seed: int = 0) -> Dict:
        """Evaluates ``weights`` (the latest checkpoint's ``state_dict``)
        against the previous ones. ``seed`` varies the stochastic games per
        checkpoint (the Trainer passes the training step); the
        ``eval_games=1`` game ignores it."""
        self.latest_net.load_state_dict(weights)
        if not self.has_prev:
            self.prev_net.load_state_dict(weights)
            self.has_prev = True
        if self.eval_games > 1:
            stats = self._evaluate_batched(seed)
        else:
            stats = eval_against_prev_ckpt(
                self.engine, self.move_fn, self.latest_net, self.prev_net,
                self.black_elo, self.white_elo, self.device)
        if self.dataset is not None and len(self.dataset) > 0:
            stats.update(self._pro_metrics())
        # Promote: the latest model is the next baseline, assumed of equal
        # strength.
        self.latest_net, self.prev_net = self.prev_net, self.latest_net
        self.white_elo = copy.deepcopy(self.black_elo)
        return stats

    def _pro_metrics(self, batch_size: int = 1024) -> Dict:
        """Pro-game metrics of the latest net, the dataset on the device
        (uploaded once), in full batches and then the tail."""
        if self._dataset_dev is None:
            ds = self.dataset
            self._dataset_dev = tuple(torch.from_numpy(x).to(self.device) for x in (
                ds.states, ds.target_pi, ds.target_v))
        states, pi, v = self._dataset_dev
        m = states.shape[0]
        bounds = [(s, s + batch_size) for s in range(0, m - batch_size + 1, batch_size)]
        if m % batch_size:
            bounds.append((m - m % batch_size, m))
        return _metrics_over(self.latest_net,
                             ((states[a:b], pi[a:b], v[a:b]) for a, b in bounds), m)

    def _play_lockstep(self, black_net, white_net, n: int, seed: int) -> Tuple:
        """N lockstep stochastic games, black's net on even plies. Returns
        the final states and the moves of game 0 (for the SGF)."""
        if self.draws is None:
            draws = match_lib.default_draws(self.engine, n, seed, self.device)
        else:
            draws = lambda ply: self.draws(seed, ply, n).to(self.device)  # noqa: E731
        states, moves = match_lib.play_lockstep(
            self.engine, self.batch_move_fn, black_net, white_net, n, draws,
            self.device, record_moves=True)
        return states, moves[0]

    def _evaluate_batched(self, seed: int) -> Dict:
        """N color-balanced stochastic games; Elo updated per game, winner
        first. ``black_elo`` tracks the latest model (the CSV column keeps
        its one-game meaning, "the promoted side"), ``white_elo`` the
        previous one."""
        n_latest_black = (self.eval_games + 1) // 2
        n_latest_white = self.eval_games - n_latest_black
        batches = [(True, *self._play_lockstep(
            self.latest_net, self.prev_net, n_latest_black, seed))]
        if n_latest_white:
            states_w, _ = self._play_lockstep(
                self.prev_net, self.latest_net, n_latest_white, seed + 1)
            batches.append((False, states_w, None))

        latest_won = prev_won = draws = 0
        lengths = []
        moves0 = batches[0][2]
        for latest_is_black, states, _ in batches:
            lengths.extend(states.step_count.cpu().tolist())
            for w in states.winner.cpu().tolist():
                if w == 0:
                    draws += 1
                    continue
                if (w == BLACK) == latest_is_black:
                    latest_won += 1
                    _update_elo(self.black_elo, self.white_elo)
                else:
                    prev_won += 1
                    _update_elo(self.white_elo, self.black_elo)

        result = f"latest {latest_won}-{prev_won}"
        if draws:
            result += f"-{draws}"
        states0 = batches[0][1]
        game0_result = result_string(
            int(states0.winner[0]), float(states0.final_score[0]), bool(states0.resigned[0]))
        stats = {
            "game_length": sum(lengths) / len(lengths),
            "game_result": result,
        }
        if self.engine.has_pass_move:
            stats["num_passes"] = sum(
                1 for m in moves0 if m.move == self.engine.pass_move)
        stats.update({
            "black_elo_rating": self.black_elo.rating,
            "white_elo_rating": self.white_elo.rating,
            "eval_games": self.eval_games,
            "latest_win_rate": latest_won / max(1, latest_won + prev_won),
            "_moves": moves0,
            "_sgf_result": game0_result,  # the SGF needs game 0's B+/W+ string
        })
        return stats
