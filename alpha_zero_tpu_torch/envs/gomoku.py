"""Batched freestyle Gomoku engine over tensors.

The port of ``alpha_zero_tpu.envs.gomoku.GomokuEngine``: players alternate
placing stones; a line of ``num_to_win`` or more same-colored stones (4
directions) wins; a full board draws; no pass, no resign. The win check is
the JAX package's full-board windowed check, K-1 shifted ANDs per direction.
The stone goes in by a direct index write where the JAX package blends a
one-hot mask (a TPU lowering); both give the same board.

``labels`` and ``group_libs`` are dummies of shape [1, 1] and [1] that keep
the state layout shared with Go (the search stores them as node state).
"""

from __future__ import annotations

import torch

from alpha_zero_tpu_torch.envs.go import GoEngine, _col, _one_action
from alpha_zero_tpu_torch.envs.types import BLACK, EMPTY, GameState
from alpha_zero_tpu_torch.utils.device import resolve_device

_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _shift_k(x: torch.Tensor, dr: int, dc: int, k: int) -> torch.Tensor:
    """x[..., i, j] -> x[..., i + k*dr, j + k*dc], False outside the board."""
    n = x.shape[-1]
    out = torch.zeros_like(x)
    r, c = k * dr, k * dc
    if abs(r) >= n or abs(c) >= n:
        return out
    out[..., max(0, -r):n - max(0, r), max(0, -c):n - max(0, c)] = (
        x[..., max(0, r):n - max(0, -r), max(0, c):n - max(0, -c)])
    return out


class GomokuEngine:
    """Static-config namespace of functions over batched :class:`GameState`."""

    def __init__(self, board_size: int = 13, num_stack: int = 8, num_to_win: int = 5,
                 max_steps: int | None = None) -> None:
        self.board_size = board_size
        self.num_stack = num_stack
        self.num_to_win = num_to_win
        self.max_steps = max_steps if max_steps is not None else board_size * board_size
        self.num_actions = board_size * board_size  # no pass move
        self.pass_move = None
        self.has_pass_move = False
        self.has_resign_move = False
        self.komi = 0.0

    # -----------------------------------------------------------------------
    def init_batch(self, batch_size: int, device="cuda") -> GameState:
        """``batch_size`` fresh games on ``device``."""
        dev = resolve_device(device)
        n = self.board_size

        def full(shape, value, dtype):
            return torch.full((batch_size,) + shape, value, dtype=dtype, device=dev)

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
            labels=full((1, 1), 0.0, torch.float32),
            group_libs=full((1,), 0.0, torch.float32),
            legal=full((self.num_actions,), 1.0, torch.float32),
        )

    def init(self, device="cuda") -> GameState:
        """One fresh game: a batch of 1."""
        return self.init_batch(1, device=device)

    # -----------------------------------------------------------------------
    def analyze(self, state: GameState) -> GameState:
        """Recomputes the cached legal mask (for hand-built states)."""
        b = state.board.shape[0]
        legal = (state.board == EMPTY).reshape(b, -1).float()
        return state.replace(legal=torch.where(_col(state.done, 2), 0.0, legal))

    def _has_win(self, board: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        """bool[B]: a run of >= num_to_win stones of ``color [B]`` in any
        direction."""
        f = board == _col(color, 3)
        win = torch.zeros(board.shape[0], dtype=torch.bool, device=board.device)
        for dr, dc in _DIRECTIONS:
            acc = f
            for k in range(1, self.num_to_win):
                acc = acc & _shift_k(f, dr, dc, k)
            win |= acc.flatten(1).any(dim=1)
        return win

    # -----------------------------------------------------------------------
    def step_batch(self, state: GameState, action: torch.Tensor) -> GameState:
        """Places a stone at flat ``action [B]`` in every game; finished
        games are left unchanged."""
        n = self.board_size
        b = action.shape[0]
        action = action.to(torch.int32)
        color = state.to_play

        board = state.board.reshape(b, -1).clone()
        board.scatter_(1, action.clamp(0, n * n - 1).long()[:, None], color[:, None])
        board = board.reshape(b, n, n)
        won = self._has_win(board, color)
        step_count = state.step_count + 1
        full = (board != EMPTY).flatten(1).all(dim=1)
        done = won | full | (step_count >= self.max_steps)

        # Reward for the mover: win 1.0, else 0 (draws give 0).
        new_state = state.replace(
            board=board,
            history=torch.cat([board[:, None], state.history[:, :-1]], dim=1),
            to_play=-color,
            step_count=step_count,
            done=done,
            winner=torch.where(won, color, 0).to(torch.int8),
            last_move=action,
            last_reward=won.float(),
            legal=((board == EMPTY).reshape(b, -1) & ~done[:, None]).float(),
        )
        return state.map2(new_state, lambda old, new: torch.where(
            _col(state.done, new.ndim), old, new))

    def step(self, state: GameState, action) -> GameState:
        """One game (a batch of 1) steps with ``action``."""
        return self.step_batch(state, _one_action(action, state))

    # -----------------------------------------------------------------------
    def with_num_stack(self, num_stack: int) -> "GomokuEngine":
        return GomokuEngine(board_size=self.board_size, num_stack=num_stack,
                            num_to_win=self.num_to_win, max_steps=self.max_steps)

    # The same stacked-plane layout as Go.
    observation_from = staticmethod(GoEngine.observation_from)

    def observation(self, state: GameState) -> torch.Tensor:
        return self.observation_from(state.history, state.to_play)
