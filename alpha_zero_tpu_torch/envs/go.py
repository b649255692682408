"""Batched Go engine over tensors.

The port of ``alpha_zero_tpu.envs.go.GoEngine``: the same rules (Minigo's
``Position``: captures, suicide, basic ko, Tromp-Taylor area scoring without
dead-stone removal), the same cached analysis in the state, written as
plain functions of batched tensors. The JAX package's one-hot matmuls
(a TPU choice) become native ``gather``/``scatter_add_``; every value is an
exact small integer, so both compute the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from alpha_zero_tpu_torch.envs.types import BLACK, EMPTY, RESIGN, WHITE, GameState
from alpha_zero_tpu_torch.utils.device import resolve_device

# 4-connectivity neighborhood.
_DIRS: Tuple[Tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1))
# Sentinel board value for off-board cells ("wall"): not empty, not a color.
_WALL = 2


def _span(d: int, n: int) -> Tuple[slice, slice]:
    """(source, destination) slices along one axis for a shift by ``d``."""
    if d < 0:
        return slice(0, n - 1), slice(1, n)
    if d > 0:
        return slice(1, n), slice(0, n - 1)
    return slice(None), slice(None)


def _shift(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """x[..., i, j] -> x[..., i + dr, j + dc], the value of each cell's
    (dr, dc)-neighbor; off-board neighbors read ``fill``."""
    n = x.shape[-1]
    (rs, rd), (cs, cd) = _span(dr, n), _span(dc, n)
    out = torch.full_like(x, fill)
    out[..., rd, cd] = x[..., rs, cs]
    return out


def _col(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] with ``ndim`` dims in total, for broadcasting."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _one_action(action, state: GameState) -> torch.Tensor:
    """``action`` as the int32[1] action batch of a one-game ``state``."""
    return torch.as_tensor(action, dtype=torch.int32,
                           device=state.board.device).reshape(1)


class GoEngine:
    """Static-config namespace of functions over batched :class:`GameState`."""

    def __init__(self, board_size: int = 9, num_stack: int = 8, komi: float = 7.5,
                 max_steps: int | None = None) -> None:
        self.board_size = board_size
        self.num_stack = num_stack
        self.komi = komi
        self.max_steps = max_steps if max_steps is not None else board_size * board_size * 2
        self.num_actions = board_size * board_size + 1  # + pass
        self.pass_move = board_size * board_size
        self.has_pass_move = True
        self.has_resign_move = True
        # Labeling sweeps run before the first convergence check; enough for
        # all practical positions, so the check usually passes at once.
        self.label_rounds = math.ceil(math.log2(board_size * board_size)) + 3

    # -----------------------------------------------------------------------
    def init_batch(self, batch_size: int, device="cuda") -> GameState:
        """``batch_size`` fresh games on ``device``."""
        dev = resolve_device(device)
        n = self.board_size
        sent = n * n
        b = batch_size

        def full(shape, value, dtype):
            return torch.full((b,) + shape, value, dtype=dtype, device=dev)

        return GameState(
            board=full((n, n), 0, torch.int8),
            history=full((self.num_stack, n, n), 0, torch.int8),
            to_play=full((), BLACK, torch.int8),
            step_count=full((), 0, torch.int32),
            done=full((), False, torch.bool),
            winner=full((), 0, torch.int8),
            last_move=full((), -2, torch.int32),
            last_reward=full((), 0.0, torch.float32),
            ko=full((), -1, torch.int32),
            pass_streak=full((), 0, torch.int32),
            num_passes=full((), 0, torch.int32),
            captures=full((2,), 0, torch.int32),
            resigned=full((), False, torch.bool),
            final_score=full((), 0.0, torch.float32),
            labels=full((n, n), float(sent), torch.float32),
            group_libs=full((sent + 1,), 0.0, torch.float32),
            legal=full((self.num_actions,), 1.0, torch.float32),
        )

    def init(self, device="cuda") -> GameState:
        """One fresh game: a batch of 1 (the single-game entry of the host
        env, the eval game and the dataset builder)."""
        return self.init_batch(1, device=device)

    # -----------------------------------------------------------------------
    # Group analysis
    # -----------------------------------------------------------------------
    def _label_sweep(self, labels, same_mask, active) -> torch.Tensor:
        """One hook (min over connected neighbors) + two pointer jumps."""
        sent = self.board_size * self.board_size
        b = labels.shape[0]
        m = labels
        for idx, (dr, dc) in enumerate(_DIRS):
            nb_label = _shift(labels, dr, dc, float(sent))
            m = torch.minimum(m, torch.where(same_mask[idx], nb_label, float(sent)))
        m = torch.where(active, m, float(sent))
        dump = torch.full((b, 1), float(sent), device=m.device)
        for _ in range(2):
            flat = m.reshape(b, -1)
            vals = torch.cat([flat, dump], dim=1)
            m = vals.gather(1, flat.long()).reshape(m.shape)
        return m

    def _label_components(self, active, same_mask) -> torch.Tensor:
        """Connected components over ``active`` [B, N, N] cells with
        per-direction connectivity ``same_mask`` (4 x [B, N, N]); returns
        min-flat-index labels (N*N for inactive cells), f32."""
        n = self.board_size
        sent = n * n
        idx = torch.arange(sent, dtype=torch.float32, device=active.device).reshape(n, n)
        labels = torch.where(active, idx, float(sent))
        for _ in range(self.label_rounds):
            labels = self._label_sweep(labels, same_mask, active)
        for _ in range(sent):
            new = self._label_sweep(labels, same_mask, active)
            if torch.equal(new, labels):
                break
            labels = new
        return labels

    def label_groups(self, board: torch.Tensor) -> torch.Tensor:
        """Group labels for stones of both colors (same-color connectivity),
        f32[B, N, N] exact integers; N*N for empty cells."""
        active = board != EMPTY
        same = [(_shift(board, dr, dc, _WALL) == board) & active for dr, dc in _DIRS]
        return self._label_components(active, same)

    def group_liberties(self, board: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Liberty count per group root: the number of *distinct* empty
        points adjacent to each group. f32[B, N*N + 1]; the last slot is a
        dump for invalid contributions (it stays 0)."""
        sent = self.board_size * self.board_size
        b = board.shape[0]
        empty = board == EMPTY
        counts = torch.zeros((b, sent + 1), dtype=torch.float32, device=board.device)
        seen = []
        for dr, dc in _DIRS:
            nb_label = _shift(labels, dr, dc, float(sent))
            dup = functools.reduce(
                torch.logical_or, [nb_label == p for p in seen], torch.zeros_like(empty))
            valid = empty & (nb_label != sent) & ~dup
            target = torch.where(valid, nb_label, float(sent)).reshape(b, -1).long()
            counts.scatter_add_(1, target, valid.reshape(b, -1).float())
            seen.append(nb_label)
        return counts

    def _compute_legal(self, board, labels, counts, ko, to_play, done) -> torch.Tensor:
        """All-points legality: empty, not suicide, not the ko point."""
        n = self.board_size
        sent = n * n
        b = board.shape[0]
        to_play = _col(to_play, 3)
        empty = board == EMPTY
        has_empty_nb = torch.zeros_like(empty)
        friendly_alive = torch.zeros_like(empty)
        captures_sth = torch.zeros_like(empty)
        for dr, dc in _DIRS:
            nb_board = _shift(board, dr, dc, _WALL)
            nb_label = _shift(labels, dr, dc, float(sent))
            libs = counts.gather(1, nb_label.reshape(b, -1).long()).reshape(b, n, n)
            nb_libs = torch.where(nb_label != sent, libs, 0.0)
            has_empty_nb |= nb_board == EMPTY
            friendly_alive |= (nb_board == to_play) & (nb_libs >= 2)
            captures_sth |= (nb_board == -to_play) & (nb_libs == 1)
        not_suicide = has_empty_nb | friendly_alive | captures_sth
        idx = torch.arange(sent, dtype=torch.int32, device=board.device).reshape(n, n)
        playable = empty & not_suicide & (idx != _col(ko, 3))
        legal = torch.cat([playable.reshape(b, -1).float(),
                           torch.ones((b, 1), device=board.device)], dim=1)
        return torch.where(_col(done, 2), 0.0, legal)

    def analyze(self, state: GameState) -> GameState:
        """Recomputes the cached analysis fields from the raw boards — for
        states built by hand (tests, SGF replay)."""
        labels = self.label_groups(state.board)
        counts = self.group_liberties(state.board, labels)
        legal = self._compute_legal(state.board, labels, counts, state.ko,
                                    state.to_play, state.done)
        return state.replace(labels=labels, group_libs=counts, legal=legal)

    # -----------------------------------------------------------------------
    # Scoring
    # -----------------------------------------------------------------------
    def area_counts(self, board: torch.Tensor) -> tuple:
        """Per-player Tromp-Taylor areas (black, white), f32[B] each, before
        komi: empty regions bordered only by one color count for it, mixed
        regions for neither; dead stones are not removed."""
        sent = self.board_size * self.board_size
        b = board.shape[0]
        empty = board == EMPTY
        same = [_shift(empty, dr, dc, False) & empty for dr, dc in _DIRS]
        labels = self._label_components(empty, same)

        target = torch.where(empty, labels, float(sent)).reshape(b, -1).long()
        black_touch = torch.zeros((b, sent + 1), device=board.device)
        white_touch = torch.zeros((b, sent + 1), device=board.device)
        for dr, dc in _DIRS:
            nb_board = _shift(board, dr, dc, _WALL).reshape(b, -1)
            black_touch.scatter_add_(1, target, (nb_board == BLACK).float())
            white_touch.scatter_add_(1, target, (nb_board == WHITE).float())

        region_black = ((black_touch > 0) & (white_touch == 0)).float()
        region_white = ((white_touch > 0) & (black_touch == 0)).float()
        empty_flat = empty.reshape(b, -1)
        terr_black = torch.where(empty_flat, region_black.gather(1, target), 0.0).sum(1)
        terr_white = torch.where(empty_flat, region_white.gather(1, target), 0.0).sum(1)

        black = (board == BLACK).reshape(b, -1).sum(1) + terr_black
        white = (board == WHITE).reshape(b, -1).sum(1) + terr_white
        return black.float(), white.float()

    def area_score(self, board: torch.Tensor) -> torch.Tensor:
        """Black-perspective Tromp-Taylor area score before komi, f32[B]."""
        black, white = self.area_counts(board)
        return black - white

    def score(self, board: torch.Tensor) -> torch.Tensor:
        """Black-perspective area score with komi, f32[B]."""
        return self.area_score(board) - self.komi

    # -----------------------------------------------------------------------
    # Step
    # -----------------------------------------------------------------------
    def step_core(self, state: GameState, action: torch.Tensor) -> GameState:
        """Plays ``action`` [B] (flat [0, N*N) board move, N*N pass, -1
        resign) in every game, WITHOUT terminal scoring (``step_batch`` adds
        it). Capture detection consumes the parent's cached analysis: an
        opponent neighbor group with one liberty dies. Finished games are
        left unchanged. Board moves must be legal (the caller's contract)."""
        n = self.board_size
        sent = n * n
        b = action.shape[0]
        dev = state.board.device
        action = action.to(torch.int32)
        is_resign = action == RESIGN
        is_pass = action == self.pass_move
        is_board_move = ~is_resign & ~is_pass
        move3 = _col(is_board_move, 3)
        color = state.to_play

        a = action.clamp(0, sent - 1).long()
        r, c = a // n, a % n
        board_flat = state.board.reshape(b, -1)
        labels_flat = state.labels.reshape(b, -1)

        # The four neighbors' board values and group labels.
        nb_vals, nb_labels = [], []
        koish = torch.ones((b,), dtype=torch.bool, device=dev)
        for dr, dc in _DIRS:
            rr, cc = r + dr, c + dc
            inb = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
            at = (rr.clamp(0, n - 1) * n + cc.clamp(0, n - 1))[:, None]
            val = torch.where(inb, board_flat.gather(1, at)[:, 0], _WALL)
            lab = torch.where(inb, labels_flat.gather(1, at)[:, 0], float(sent))
            nb_vals.append(val)
            nb_labels.append(lab)
            # koish: every in-bounds neighbor is an opponent stone.
            koish &= ~inb | (val == -color)

        # Captured groups: opponent neighbors in atari (their single
        # liberty is the played point).
        captured = torch.zeros((b, n, n), dtype=torch.bool, device=dev)
        for val, lab in zip(nb_vals, nb_labels):
            libs = state.group_libs.gather(1, lab.clamp(0, sent).long()[:, None])[:, 0]
            dies = is_board_move & (val == -color) & (libs == 1)
            captured |= _col(dies, 3) & (state.labels == _col(lab, 3))
        num_captured = captured.reshape(b, -1).sum(1, dtype=torch.int32)

        point_oh = (torch.arange(sent, device=dev).reshape(n, n) == _col(a, 3))
        board1 = torch.where(point_oh & move3, _col(color, 3), state.board)
        new_board = torch.where(captured, EMPTY, board1)
        new_board = torch.where(move3, new_board, state.board)

        # Basic ko: a single capture from a koish point.
        first_cap = captured.reshape(b, -1).to(torch.uint8).argmax(1).to(torch.int32)
        new_ko = torch.where(is_board_move & (num_captured == 1) & koish, first_cap, -1)

        # Bookkeeping.
        pass_streak = torch.where(is_pass, state.pass_streak + 1, 0)
        caps_add = torch.where(
            (color == BLACK)[:, None],
            torch.tensor([1, 0], dtype=torch.int32, device=dev),
            torch.tensor([0, 1], dtype=torch.int32, device=dev),
        ) * num_captured[:, None]
        step_count = state.step_count + 1
        history = torch.cat([new_board[:, None], state.history[:, :-1]], dim=1)

        # Termination: resign, two consecutive passes, or max_steps. Winner
        # and reward of score-decided games are filled by step_batch.
        done = is_resign | (pass_streak >= 2) | (step_count >= self.max_steps)
        winner = torch.where(is_resign, -color, 0).to(torch.int8)
        reward = torch.where(is_resign, -1.0, 0.0)

        # Incremental labels: the placed stone merges the adjacent friendly
        # groups under min(point, their labels); captured groups vanish.
        friendly = [torch.where(val == color, lab, float(sent))
                    for val, lab in zip(nb_vals, nb_labels)]
        merged = functools.reduce(torch.minimum, friendly, a.float())
        absorbed = functools.reduce(
            torch.logical_or,
            [(state.labels == _col(f, 3)) & _col(f < sent, 3) for f in friendly])
        labels = torch.where(absorbed | point_oh, _col(merged, 3), state.labels)
        labels = torch.where(captured, float(sent), labels)
        labels = torch.where(move3, labels, state.labels)
        counts = self.group_liberties(new_board, labels)
        legal = self._compute_legal(new_board, labels, counts, new_ko, -color, done)

        new_state = GameState(
            board=new_board,
            history=history,
            to_play=-color,
            step_count=step_count,
            done=done,
            winner=winner,
            last_move=action,
            last_reward=reward,
            ko=new_ko,
            pass_streak=pass_streak,
            num_passes=state.num_passes + is_pass.to(torch.int32),
            captures=state.captures + caps_add,
            resigned=is_resign,
            final_score=torch.zeros((b,), device=dev),
            labels=labels,
            group_libs=counts,
            legal=legal,
        )
        # A finished game ignores further steps.
        return state.map2(new_state, lambda old, new: torch.where(
            _col(state.done, new.ndim), old, new))

    def _finalize_scores(self, was_done: torch.Tensor, stepped: GameState) -> GameState:
        """Fills winner/reward/final_score for games that just ended by
        double pass or max_steps (resign is already settled). Scores only
        when some game needs it."""
        needs = stepped.done & ~stepped.resigned & ~was_done
        if not bool(needs.any()):
            return stepped
        scores = self.score(stepped.board)
        score_winner = torch.where(
            scores > 0, 1, torch.where(scores < 0, -1, 0)).to(torch.int8)
        mover = -stepped.to_play  # the player who made the move
        reward = torch.where(score_winner != 0,
                             torch.where(score_winner == mover, 1.0, -1.0), 0.0)
        return stepped.replace(
            winner=torch.where(needs, score_winner, stepped.winner),
            last_reward=torch.where(needs, reward, stepped.last_reward),
            final_score=torch.where(needs, scores, stepped.final_score),
        )

    def step_batch(self, states: GameState, actions: torch.Tensor) -> GameState:
        """Batched step with terminal scoring — the hot-path entry point."""
        return self._finalize_scores(states.done, self.step_core(states, actions))

    def step(self, state: GameState, action) -> GameState:
        """One game (a batch of 1) steps with ``action`` (an int or a
        one-element tensor), terminal scoring included."""
        return self.step_batch(state, _one_action(action, state))

    # -----------------------------------------------------------------------
    # Observation
    # -----------------------------------------------------------------------
    def with_num_stack(self, num_stack: int) -> "GoEngine":
        """Same rules, different history depth (the search stores 1-deep
        states and rebuilds observation stacks from ancestor boards)."""
        return GoEngine(board_size=self.board_size, num_stack=num_stack,
                        komi=self.komi, max_steps=self.max_steps)

    @staticmethod
    def observation_from(history: torch.Tensor, to_play: torch.Tensor) -> torch.Tensor:
        """Stacked feature planes from explicit board histories [B, S, N, N]
        (latest first): channel-last int8[B, N, N, 2*S+1], planes
        [Xt, Yt, Xt-1, Yt-1, ..., C] with C = 1 when black is to play."""
        b, s, n, _ = history.shape
        tp = _col(to_play, 4)
        planes = torch.stack([history == tp, history == -tp], dim=2).reshape(b, 2 * s, n, n)
        color = (tp == BLACK).expand(b, 1, n, n)
        obs = torch.cat([planes, color], dim=1).to(torch.int8)
        return obs.permute(0, 2, 3, 1)

    def observation(self, state: GameState) -> torch.Tensor:
        """Observations from the states' own rolled histories."""
        return self.observation_from(state.history, state.to_play)
