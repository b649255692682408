"""Pro-game evaluation dataset builder (SGF -> tensors).

The port of ``alpha_zero_tpu.eval.dataset``, with the same filters:
board-size match, a valid non-timeout result, minimum Elo 2100 when ratings
are recoverable, duplicate-game detection, at most 200 games per player.
Each surviving game is replayed through the engine into (observation,
one-hot human move, +-1 value) tuples, and the engine's score is checked
against the SGF result (mismatch accounting kept).

Two paths, as in the JAX package: the fast one (``replay_games_batched``)
replays length-sorted chunks of games in lockstep through the batched
engine on ``device``; the slow one replays game by game through the host
``GoEnv``. Observations are NHWC int8. The npz cache has the JAX package's
keys and fingerprint, so a cache written by either package loads in the
other.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.host import GoEnv
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.coords import CoordsConvertor
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import create_logger


@dataclass
class EvalDataset:
    states: np.ndarray     # [M, N, N, C] int8 (NHWC)
    target_pi: np.ndarray  # [M, A] float32 one-hot human moves
    target_v: np.ndarray   # [M] float32 +-1 outcomes
    num_games: int = 0
    mismatch_stats: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.target_v)


def get_sgf_files(games_dir: str) -> List[str]:
    results = []
    if os.path.exists(games_dir):
        for root, _, filenames in os.walk(games_dir):
            for f in filenames:
                if f.endswith(".sgf"):
                    results.append(os.path.join(root, f))
    return sorted(results)


def _corpus_fingerprint(games_dir: str, num_stack: int) -> str:
    """Identity of (corpus, num_stack) for npz-cache invalidation: SGF file
    count, total bytes and num_stack."""
    files = get_sgf_files(games_dir)
    total = 0
    for f in files:
        try:
            total += os.path.getsize(f)
        except OSError:
            pass
    return f"v1:files={len(files)}:bytes={total}:stack={num_stack}"


def _player_str(player: Optional[str]) -> str:
    player = player or ""
    player = re.sub(r"\([^)]*\)", "", player)
    player = re.sub(r"[^a-zA-Z0-9 ]", "", player)
    return player.strip()


def _extract_ratings(black_player, white_player, black_rank, white_rank) -> List[int]:
    """Elo from rank props ('BR[2345]') or embedded in names ('PW[Bob (2435)]');
    dan/kyu/pro ranks like '9d' are skipped."""
    ratings: List[int] = []
    if all(
        rank is not None and rank != "" and "k" not in rank and "d" not in rank and "p" not in rank
        for rank in (black_rank, white_rank)
    ):
        for rank in (black_rank, white_rank):
            try:
                ratings.append(int(re.sub(r"[^0-9]", "", rank)))
            except Exception:
                pass
    elif all(
        p is not None and "(" in p and ")" in p for p in (black_player, white_player)
    ):
        for player_id in (black_player, white_player):
            elo = re.search(r"\((\d+)\)", player_id)
            if elo:
                ratings.append(int(elo.group(1)))
    return ratings


class DatasetBuilder:
    """Stateful builder (dedup and per-player caps live across files)."""

    def __init__(self, board_size: int, num_stack: int, logger=None,
                 min_elo: int = 2100, max_games_per_player: int = 200,
                 skip_n: int = 0, device="cuda") -> None:
        self.board_size = board_size
        self.num_stack = num_stack
        self.logger = logger or create_logger()
        self.min_elo = min_elo
        self.max_games_per_player = max_games_per_player
        self.skip_n = skip_n
        self.device = resolve_device(device)
        self.game_counts: Dict[str, int] = {}
        self.matches: set = set()
        self.mismatch = {
            "winner_mismatch": 0,
            "score_mismatch": 0,
            "score_mismatch_le_1": 0,
            "score_mismatch_gt_1_le_2": 0,
            "score_mismatch_gt_2_le_4": 0,
            "score_mismatch_gt_4": 0,
        }

    def prefilter(self, sgf_file: str):
        """Metadata filters only (no engine replay). Returns
        (komi, moves [(color, flat)], winner, result_str, players) or None."""
        try:
            with open(sgf_file) as f:
                content = f.read()
            game = sgf_lib.parse_sgf(content)
        except Exception:
            return None

        if game.board_size is None or game.board_size != self.board_size:
            return None
        result_str = game.result
        if result_str is None or len(result_str) < 3:
            return None
        if re.search(r"\+T", result_str):  # timeout: no natural winner
            return None

        black_player = game.prop("PB")
        white_player = game.prop("PW")
        ratings = _extract_ratings(black_player, white_player,
                                   game.prop("BR"), game.prop("WR"))
        if ratings and any(v < self.min_elo for v in ratings):
            return None

        black_id = _player_str(black_player)
        white_id = _player_str(white_player)
        num_moves = len(game.moves)
        match_str = f"{black_id}-{white_id}-{num_moves}-{result_str}"
        if match_str in self.matches:
            return None
        self.matches.add(match_str)

        # Cap check only: ``count_game`` charges a game once it replays
        # legally, so broken games spend no player's budget.
        for pid in (black_id, white_id):
            if self.game_counts.get(pid, 0) > self.max_games_per_player:
                return None

        cc = CoordsConvertor(self.board_size)
        try:
            flat_moves = [(c, cc.to_flat(cc.from_sgf(m))) for c, m in game.moves]
        except Exception:
            return None
        winner = sgf_lib.parse_game_result(result_str)
        return (game.komi or 0.0, flat_moves, winner, result_str,
                (black_id, white_id))

    def count_game(self, players: Tuple[str, str]) -> None:
        """Charges a successfully replayed game to both players' caps."""
        for pid in players:
            self.game_counts[pid] = self.game_counts.get(pid, 0) + 1

    def replay_sgf(self, sgf_file: str) -> Optional[List[Tuple[np.ndarray, np.ndarray, float]]]:
        """The slow path: one game through the host ``GoEnv``."""
        meta = self.prefilter(sgf_file)
        if meta is None:
            return None
        komi, game_moves, winner, result_str, players = meta
        env = GoEnv(board_size=self.board_size, komi=komi, num_stack=self.num_stack,
                    device=self.device)

        history: List[Tuple[np.ndarray, np.ndarray, float]] = []
        obs_nhwc = np.transpose(env.observation(), (1, 2, 0))
        for color, move in game_moves:
            player = env.black_player if color == "B" else env.white_player
            if not env.is_legal_move(move):
                return None
            if env.to_play != player:  # handicap / out-of-turn games
                return None
            value = 0.0
            if winner != 0:
                value = 1.0 if (winner == 1) == (player == env.black_player) else -1.0
            if env.steps > self.skip_n:
                one_hot = np.zeros(env.action_dim, np.float32)
                one_hot[move] = 1.0
                history.append((obs_nhwc.astype(np.int8), one_hot, value))
            try:
                obs_chw, _, _, _ = env.step(move)
            except Exception:
                return None
            obs_nhwc = np.transpose(obs_chw, (1, 2, 0))

        self._check_mismatch_result(env.get_result_string(), result_str)
        self.count_game(players)
        return history

    def check_mismatch_score(self, score: float, result_str: str) -> None:
        """Mismatch accounting from a raw black-perspective score (fast path)."""
        if score > 0:
            env_result = "B+%.1f" % score
        elif score < 0:
            env_result = "W+%.1f" % abs(score)
        else:
            env_result = "DRAW"
        self._check_mismatch_result(env_result, result_str)

    def _check_mismatch_result(self, env_result: str, result_str: str) -> None:
        env_result = env_result.upper()
        result_str = result_str.upper()
        if re.search(r"\+T", result_str) or re.search(r"\+R", result_str):
            return
        if env_result[:2] != result_str[:2]:
            self.mismatch["winner_mismatch"] += 1
            return
        sgf_score = re.findall(r"[-+]?\d*\.\d+|\d+", result_str)
        env_score = re.findall(r"[-+]?\d*\.\d+|\d+", env_result)
        sgf_val = float(sgf_score[0]) if sgf_score else None
        env_val = float(env_score[0]) if env_score else None
        if sgf_val != env_val:
            self.mismatch["score_mismatch"] += 1
            delta = abs((sgf_val or 0) - (env_val or 0))
            if delta <= 1:
                self.mismatch["score_mismatch_le_1"] += 1
            elif delta <= 2:
                self.mismatch["score_mismatch_gt_1_le_2"] += 1
            elif delta <= 4:
                self.mismatch["score_mismatch_gt_2_le_4"] += 1
            else:
                self.mismatch["score_mismatch_gt_4"] += 1


def replay_games_batched(board_size: int, num_stack: int, games, skip_n: int = 0,
                         device="cuda"):
    """Replays parsed games in lockstep through the batched engine on
    ``device`` (the fast path).

    ``games``: (komi, [(color, flat_move)], winner) tuples that passed the
    metadata filters. Returns, per game, (transitions, black-perspective
    score with the game's komi), or None for a game with an illegal or
    out-of-turn move. A transition is (obs NHWC int8, one-hot move, value).
    """
    if not games:
        return []
    dev = resolve_device(device)
    num_games = len(games)
    max_len = max(len(moves) for _, moves, _ in games)
    a_dim = board_size * board_size + 1
    pass_move = board_size * board_size

    # Move sequences padded with passes (masked out by length).
    move_arr = np.full((num_games, max_len), pass_move, np.int32)
    color_arr = np.zeros((num_games, max_len), np.int8)
    lengths = np.zeros(num_games, np.int32)
    for i, (_, moves, _) in enumerate(games):
        lengths[i] = len(moves)
        for j, (color, mv) in enumerate(moves):
            move_arr[i, j] = mv
            color_arr[i, j] = 1 if color == "B" else -1

    # Komi only affects scoring, so one komi-0 engine replays every game
    # and each game's komi comes off its area score afterwards.
    engine = GoEngine(board_size=board_size, num_stack=num_stack, komi=0.0,
                      max_steps=max_len + 2)
    moves_dev = torch.from_numpy(move_arr).to(dev)
    colors_dev = torch.from_numpy(color_arr).to(dev)
    active_dev = torch.from_numpy(np.arange(max_len)[None, :] < lengths[:, None]).to(dev)
    lanes = torch.arange(num_games, device=dev)

    states = engine.init_batch(num_games, device=dev)
    ok = torch.ones(num_games, dtype=torch.bool, device=dev)
    all_obs = []
    for j in range(max_len):
        mv = moves_dev[:, j]
        # The reference's filters: an illegal move or an out-of-turn
        # (handicap) game. ``legal`` is f32 0/1.
        legal_here = states.legal[lanes, mv.long()] > 0.5
        ok &= ~active_dev[:, j] | (legal_here & (states.to_play == colors_dev[:, j]))
        all_obs.append(engine.observation(states))
        # Finished games step a pass (harmless; their rows are masked).
        states = engine.step_batch(states, mv)
    final_scores = engine.area_score(states.board).cpu().numpy()
    obs = torch.stack(all_obs, dim=1).cpu().numpy()  # [G, L, N, N, C]
    ok = ok.cpu().numpy()

    results = []
    for i, (komi, moves, winner) in enumerate(games):
        if not ok[i]:
            results.append(None)
            continue
        history = []
        for j in range(lengths[i]):
            # The slow path records the position before move j when
            # env.steps (== j) > skip_n, so the empty board is skipped.
            if j <= skip_n:
                continue
            one_hot = np.zeros(a_dim, np.float32)
            one_hot[moves[j][1]] = 1.0
            player = 1 if moves[j][0] == "B" else -1
            value = 0.0
            if winner != 0:
                value = 1.0 if winner == player else -1.0
            history.append((obs[i, j], one_hot, value))
        results.append((history, float(final_scores[i]) - komi))
    return results


def build_eval_dataset(games_dir: str, board_size: int, num_stack: int,
                       logger=None, fast: bool = True, chunk_size: int = 2048,
                       cache_path: Optional[str] = None, device="cuda",
                       **kwargs) -> EvalDataset:
    """Builds the dataset: ``fast`` replays all games in lockstep on
    ``device`` (length-sorted chunks bound the padding), else game by game
    through the host env.

    ``cache_path``: npz file to load the tensors from when its fingerprint
    matches the corpus, and to store them in after a build."""
    logger = logger or create_logger()
    fingerprint = _corpus_fingerprint(games_dir, num_stack)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        cached_fp = str(z["fingerprint"]) if "fingerprint" in z else None
        if cached_fp == fingerprint:
            ds = EvalDataset(
                states=z["states"], target_pi=z["target_pi"], target_v=z["target_v"],
                num_games=int(z["num_games"]),
                mismatch_stats={k: int(v) for k, v in zip(z["mismatch_keys"],
                                                          z["mismatch_vals"])},
            )
            logger.info(
                f"Loaded cached eval dataset {cache_path}: {len(ds)} positions "
                f"from {ds.num_games} games"
            )
            return ds
        logger.info(
            f"Eval dataset cache {cache_path} is stale "
            f"(fingerprint {cached_fp} != {fingerprint}); rebuilding"
        )
    builder = DatasetBuilder(board_size, num_stack, logger, device=device, **kwargs)
    states, target_pi, target_v = [], [], []
    valid_games = 0

    if fast:
        metas = []
        for sgf_file in get_sgf_files(games_dir):
            meta = builder.prefilter(sgf_file)
            if meta is not None:
                metas.append(meta)
        metas.sort(key=lambda m: len(m[1]))
        for start in range(0, len(metas), chunk_size):
            chunk = metas[start:start + chunk_size]
            results = replay_games_batched(
                board_size, num_stack,
                [(k, mv, w) for k, mv, w, _, _ in chunk],
                skip_n=builder.skip_n, device=builder.device,
            )
            for (komi, mv, w, result_str, players), res in zip(chunk, results):
                if res is None:
                    continue
                # The per-player cap, charged in replay order (the slow
                # path charges it at replay, between prefilters).
                if any(builder.game_counts.get(p, 0) > builder.max_games_per_player
                       for p in players):
                    continue
                history, score = res
                builder.count_game(players)
                valid_games += 1
                if not re.search(r"\+R", result_str, re.IGNORECASE):
                    builder.check_mismatch_score(score, result_str)
                for s, p, v in history:
                    states.append(s)
                    target_pi.append(p)
                    target_v.append(v)
    else:
        for sgf_file in get_sgf_files(games_dir):
            history = builder.replay_sgf(sgf_file)
            if history is None:
                continue
            valid_games += 1
            for s, p, v in history:
                states.append(s)
                target_pi.append(p)
                target_v.append(v)

    if not states:
        n = board_size
        c = 2 * num_stack + 1
        return EvalDataset(
            states=np.zeros((0, n, n, c), np.int8),
            target_pi=np.zeros((0, n * n + 1), np.float32),
            target_v=np.zeros((0,), np.float32),
            num_games=0,
            mismatch_stats=builder.mismatch,
        )
    dataset = EvalDataset(
        states=np.stack(states),
        target_pi=np.stack(target_pi),
        target_v=np.asarray(target_v, np.float32),
        num_games=valid_games,
        mismatch_stats=builder.mismatch,
    )
    logger.info(f"Finished loading {len(dataset)} positions from {valid_games} games")
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        np.savez_compressed(
            cache_path, states=dataset.states, target_pi=dataset.target_pi,
            target_v=dataset.target_v, num_games=dataset.num_games,
            mismatch_keys=np.array(list(dataset.mismatch_stats), dtype=str),
            mismatch_vals=np.array(list(dataset.mismatch_stats.values())),
            fingerprint=np.array(fingerprint),
        )
        logger.info(f"Cached eval dataset to {cache_path}")
    return dataset
