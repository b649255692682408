"""Plain Go, one game at a time, in NumPy: the benchmark's engine reference.

The rules are Minigo's ``Position`` as michaelnny/alpha_zero plays them:
stones capture an opponent group left without liberties, suicide is
illegal, basic ko (a single stone captured by a stone played on a point
whose in-board neighbours are all opponent stones) forbids the immediate
recapture, and a game ends on two passes in a row or after ``max_steps``
moves, scored by Tromp-Taylor area (stones plus empty regions that touch
only one colour) less komi, with no dead-stone removal. The observation is
AlphaZero's: the last ``num_stack`` boards, latest first, as
(own stones, opponent stones) planes of the player to move, and one plane
that is 1 when black is to move, channel last.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage

BLACK, WHITE, EMPTY = 1, -1, 0
_FOUR = ndimage.generate_binary_structure(2, 1)


@dataclasses.dataclass(frozen=True)
class Rules:
    board_size: int
    num_stack: int
    komi: float
    max_steps: int

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size + 1

    @property
    def pass_move(self) -> int:
        return self.board_size * self.board_size


def rules(env: dict) -> Rules:
    """The rules of a configuration file's ``env``."""
    return Rules(env["board_size"], env["num_stack"], env["komi"], env["max_steps"])


def _neighbours(x: np.ndarray, fill) -> np.ndarray:
    """[4, N, N]: each cell's up, down, left and right neighbour's value;
    ``fill`` off the board."""
    p = np.pad(x, 1, constant_values=fill)
    return np.stack([p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]])


def _groups(board: np.ndarray):
    """(labels, liberties): ``labels [N, N]`` numbers every group of
    either colour from 1 (0 on empty points); ``liberties[g]`` is the
    number of distinct empty points next to group g."""
    black, nb = ndimage.label(board == BLACK, _FOUR)
    white, nw = ndimage.label(board == WHITE, _FOUR)
    labels = np.where(white > 0, white + nb, black)
    groups = nb + nw + 1
    nbr = _neighbours(labels, 0)[:, board == EMPTY]
    cell = np.nonzero((board == EMPTY).reshape(-1))[0]
    codes = np.unique((cell[None] * groups + nbr)[nbr > 0])
    libs = np.bincount(codes % groups, minlength=groups)
    return labels, libs


class Position:
    """One game's state after some moves; ``play`` returns the next one."""

    __slots__ = ("rules", "board", "history", "to_play", "ko", "pass_streak",
                 "num_passes", "step_count", "done", "winner", "final_score",
                 "reward", "_legal")

    def __init__(self, rules: Rules) -> None:
        n = rules.board_size
        self.rules = rules
        self.board = np.zeros((n, n), np.int8)
        self.history = np.zeros((rules.num_stack, n, n), np.int8)
        self.to_play = BLACK
        self.ko = -1
        self.pass_streak = 0
        self.num_passes = 0
        self.step_count = 0
        self.done = False
        self.winner = 0
        self.final_score = 0.0
        self.reward = 0.0  # of the last move, from its mover's view
        self._legal = None

    def _copy(self) -> "Position":
        new = Position.__new__(Position)
        for name in Position.__slots__:
            setattr(new, name, getattr(self, name))
        new._legal = None
        return new

    def legal(self) -> np.ndarray:
        """float32 [A]: 1 where the player to move may play (pass always,
        while the game runs); all 0 once it is over."""
        if self._legal is not None:
            return self._legal
        r = self.rules
        out = np.zeros(r.num_actions, np.float32)
        if not self.done:
            labels, libs = _groups(self.board)
            nb_board = _neighbours(self.board, 2)
            nb_libs = libs[_neighbours(labels, 0)]
            own = nb_board == self.to_play
            opp = nb_board == -self.to_play
            ok = ((nb_board == EMPTY) | (own & (nb_libs >= 2)) | (opp & (nb_libs == 1))).any(0)
            ok &= self.board == EMPTY
            flat = ok.reshape(-1)
            if self.ko >= 0:
                flat[self.ko] = False
            out[:-1] = flat
            out[-1] = 1.0
        self._legal = out
        return out

    def play(self, move: int) -> "Position":
        """The position after the player to move plays ``move`` (a flat
        board point, or ``pass_move``). Raises on an illegal move."""
        r = self.rules
        if self.done or not 0 <= move < r.num_actions or self.legal()[move] != 1.0:
            raise ValueError(f"illegal move {move}")
        new = self._copy()
        color = self.to_play
        n = r.board_size
        if move == r.pass_move:
            new.pass_streak = self.pass_streak + 1
            new.num_passes = self.num_passes + 1
            new.ko = -1
        else:
            row, col = divmod(move, n)
            labels, libs = _groups(self.board)
            board = self.board.copy()
            koish = True
            captured = np.zeros_like(board, bool)
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                rr, cc = row + dr, col + dc
                if not (0 <= rr < n and 0 <= cc < n):
                    continue
                if board[rr, cc] != -color:
                    koish = False
                elif libs[labels[rr, cc]] == 1:
                    captured |= labels == labels[rr, cc]
            board[row, col] = color
            board[captured] = EMPTY
            new.board = board
            taken = np.flatnonzero(captured)
            new.ko = int(taken[0]) if koish and taken.size == 1 else -1
            new.pass_streak = 0
        new.step_count = self.step_count + 1
        new.history = np.concatenate([new.board[None], self.history[:-1]])
        new.to_play = -color
        new.reward = 0.0
        if new.pass_streak >= 2 or new.step_count >= r.max_steps:
            new.done = True
            score = area_score(new.board) - r.komi
            new.final_score = float(np.float32(score))
            new.winner = BLACK if score > 0 else WHITE if score < 0 else 0
            new.reward = 0.0 if new.winner == 0 else 1.0 if new.winner == color else -1.0
        return new

    def observation(self, boards: np.ndarray | None = None) -> np.ndarray:
        """int8 [N, N, 2 * num_stack + 1] of ``boards`` (default: this
        game's own history), seen by the player to move."""
        h = self.history if boards is None else boards
        tp = self.to_play
        planes = np.stack([h == tp, h == -tp], axis=1).reshape(-1, *h.shape[1:])
        color = np.full((1,) + h.shape[1:], tp == BLACK)
        return np.concatenate([planes, color]).astype(np.int8).transpose(1, 2, 0)


def area_score(board: np.ndarray) -> float:
    """Black's Tromp-Taylor area less white's, before komi."""
    regions, count = ndimage.label(board == EMPTY, _FOUR)
    nbr = _neighbours(board, 2)
    black_touch = np.zeros(count + 1, bool)
    white_touch = np.zeros(count + 1, bool)
    for d in range(4):
        black_touch[regions[nbr[d] == BLACK]] = True
        white_touch[regions[nbr[d] == WHITE]] = True
    sizes = np.bincount(regions.reshape(-1), minlength=count + 1)
    sizes[0] = 0
    black = int((board == BLACK).sum()) + int(sizes[black_touch & ~white_touch].sum())
    white = int((board == WHITE).sum()) + int(sizes[white_touch & ~black_touch].sum())
    return float(black - white)
