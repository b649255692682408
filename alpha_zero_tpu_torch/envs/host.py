"""Single-game host environments over the batched engines.

The port of ``alpha_zero_tpu.envs.host``: the Gym-like surface of the
reference envs (``reset/step/observation/legal_actions/to_play/winner/
render/to_sgf/gtp_to_action``) for the play CLI, SGF replay and tests. The
game is a batch of 1 on ``device`` (default ``cuda``); the queries copy it
to the host. The hot paths (self-play, matches, the evaluator) never go
through this layer.

Observations are returned channel-first [C, N, N], as the reference's are;
player ids are the reference's (Go: black +1, white -1; Gomoku: 1 and 2).
"""

from __future__ import annotations

import io
import sys
from collections import namedtuple
from typing import Optional, Tuple

import numpy as np

from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.gomoku import GomokuEngine
from alpha_zero_tpu_torch.envs.types import BLACK, WHITE
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.coords import CoordsConvertor
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import get_time_stamp

PlayerMove = namedtuple("PlayerMove", ["color", "move"])


class _HostEnv:
    """Shared host wrapper; subclasses bind an engine and the id mapping."""

    def __init__(self, engine, black_player_id: int, white_player_id: int,
                 id: str = "", device="cuda") -> None:
        self.engine = engine
        self.device = resolve_device(device)
        self.id = id
        self.board_size = engine.board_size
        self.num_stack = engine.num_stack
        self.black_player = black_player_id
        self.white_player = white_player_id
        self.has_pass_move = engine.has_pass_move
        self.has_resign_move = engine.has_resign_move
        self.action_dim = engine.num_actions
        self.pass_move = engine.pass_move
        self.resign_move = -1 if self.has_resign_move else None
        self.cc = CoordsConvertor(self.board_size)
        self.gtp_columns = "ABCDEFGHJKLMNOPQRSTUVWXYZ"
        self.gtp_rows = [str(i) for i in range(self.board_size, -1, -1)]
        self.reset()

    # -- id mapping ---------------------------------------------------------
    def _color_to_id(self, color: int) -> int:
        return self.black_player if color == BLACK else self.white_player

    def _id_to_color(self, player_id) -> int:
        return BLACK if player_id == self.black_player else WHITE

    # -- API ----------------------------------------------------------------
    def reset(self, **kwargs) -> np.ndarray:
        self.state = self.engine.init(self.device)
        self.steps = 0
        self.last_player = None
        self.last_move = None
        self.history: list[PlayerMove] = []
        self._refresh()
        return self.observation()

    def _refresh(self) -> None:
        self.board = self.state.board[0].cpu().numpy()
        self.legal_actions = self.state.legal[0].cpu().numpy().astype(np.int8)
        self.to_play = self._color_to_id(int(self.state.to_play[0]))

    def observation(self) -> np.ndarray:
        obs = self.engine.observation(self.state)[0].cpu().numpy()
        return np.transpose(obs, (2, 0, 1))  # NHWC -> the reference's CHW

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        if self.is_game_over():
            raise RuntimeError("Game is over, call reset before using step method.")
        if action is not None and action != self.resign_move and not 0 <= int(action) <= self.action_dim - 1:
            raise ValueError(f"Invalid action. The action {action} is out of bound.")
        if action is not None and action != self.resign_move and self.legal_actions[int(action)] != 1:
            raise ValueError(f"Illegal action {action}.")

        self.last_move = int(action)
        self.last_player = self.to_play
        self.steps += 1
        if action != self.resign_move:
            self.add_to_history(self.last_player, self.last_move)

        self.state = self.engine.step(self.state, int(action))
        self._refresh()
        reward = float(self.state.last_reward[0])
        done = bool(self.state.done[0])
        return self.observation(), reward, done, {}

    def add_to_history(self, player_id, move) -> None:
        if move != self.resign_move:
            self.history.append(PlayerMove(color=self.get_player_name_by_id(player_id), move=move))

    # -- queries ------------------------------------------------------------
    @property
    def winner(self) -> Optional[int]:
        w = int(self.state.winner[0])
        return None if w == 0 else self._color_to_id(w)

    @property
    def opponent_player(self) -> int:
        return self.white_player if self.to_play == self.black_player else self.black_player

    def is_game_over(self) -> bool:
        return bool(self.state.done[0])

    def is_board_full(self) -> bool:
        return bool(np.all(self.board != 0))

    def get_player_name_by_id(self, player_id) -> Optional[str]:
        if player_id == self.black_player:
            return "B"
        if player_id == self.white_player:
            return "W"
        return None

    # -- coords -------------------------------------------------------------
    def is_coords_on_board(self, coords: Tuple[int, int]) -> bool:
        x, y = coords
        return (max(x, y) < self.board_size) and (min(x, y) >= 0)

    def action_to_coords(self, action: Optional[int]) -> Tuple[int, int]:
        if action is None:
            return (-1, -1)
        coords = self.cc.from_flat(action)
        return (-1, -1) if coords is None else coords

    def action_to_gtp(self, action: Optional[int]):
        try:
            return self.cc.to_gtp(self.cc.from_flat(action))
        except Exception:
            return None

    def coords_to_action(self, coords: Tuple[int, int]) -> Optional[int]:
        try:
            if self.is_coords_on_board(coords):
                return self.cc.to_flat(coords)
            return None
        except Exception:
            return None

    def gtp_to_action(self, gtpc: str, check_illegal: bool = True) -> Optional[int]:
        try:
            action = self.cc.to_flat(self.cc.from_gtp(gtpc))
            if action < 0 or action >= self.action_dim:
                return None
            if check_illegal and self.legal_actions[action] != 1:
                return None
            return action
        except Exception:
            return None

    def is_pass_move(self, move: int) -> bool:
        return self.has_pass_move and move == self.pass_move

    def is_resign_move(self, move: int) -> bool:
        return self.has_resign_move and move == self.resign_move

    def is_legal_move(self, move: Optional[int]) -> bool:
        if move is None or move < 0 or move > self.action_dim - 1:
            return False
        return self.legal_actions[move] == 1

    # -- rendering ----------------------------------------------------------
    def render(self, mode: str = "terminal"):
        outfile = io.StringIO() if mode == "ansi" else sys.stdout
        black_stone, white_stone = "X", "O"
        outfile.write(f"{self.id} ({self.board_size}x{self.board_size})\n")
        outfile.write(f"Black: {black_stone}, White: {white_stone}\n\n")
        game_over_label = "Yes" if self.is_game_over() else "No"
        outfile.write(f"Game over: {game_over_label}, Result: {self.get_result_string()}\n")
        outfile.write(
            f"Steps: {self.steps}, Current player: "
            f"{black_stone if self.to_play == self.black_player else white_stone}\n\n"
        )
        outfile.write("     ")
        for y in range(self.board_size):
            outfile.write("{0:3}".format(self.gtp_columns[y]))
        outfile.write("\n   +" + "-" * self.board_size * 3 + "+\n")
        last_coords = self.action_to_coords(self.last_move)
        for r in range(self.board_size):
            outfile.write("{0:2} |".format(self.gtp_rows[r]))
            for col in range(self.board_size):
                cell = "."
                if self.board[r, col] == self._id_to_color(self.black_player):
                    cell = black_stone
                elif self.board[r, col] == self._id_to_color(self.white_player):
                    cell = white_stone
                if (r, col) == last_coords:
                    cell = f"({cell})"
                outfile.write(f"{cell}".center(3))
            outfile.write("| {0:2}\r\n".format(self.gtp_rows[r]))
        outfile.write("   +" + "-" * self.board_size * 3 + "+\n     ")
        for y in range(self.board_size):
            outfile.write("{0:3}".format(self.gtp_columns[y]))
        outfile.write("\n\n")
        return outfile

    # -- to be specialized ---------------------------------------------------
    def get_result_string(self) -> str:
        return ""

    def to_sgf(self) -> str:
        return ""


class GoEnv(_HostEnv):
    """Go with pass/resign, komi, basic ko, Tromp-Taylor scoring; black +1,
    white -1."""

    def __init__(self, board_size: int = 9, komi: float = 7.5, num_stack: int = 8,
                 max_steps: Optional[int] = None, device="cuda") -> None:
        engine = GoEngine(board_size=board_size, num_stack=num_stack, komi=komi,
                          max_steps=max_steps)
        self.komi = komi
        self.max_steps = engine.max_steps
        super().__init__(engine, black_player_id=BLACK, white_player_id=WHITE, id="Go",
                         device=device)

    def get_captures(self):
        caps = self.state.captures[0].cpu().numpy()
        return {self.black_player: int(caps[0]), self.white_player: int(caps[1])}

    def get_result_string(self) -> str:
        if bool(self.state.resigned[0]):
            return "B+R" if self.winner == self.black_player else "W+R"
        if not self.is_game_over():
            # An unfinished game is scored on its current board.
            score = float(self.engine.score(self.state.board)[0])
        else:
            score = float(self.state.final_score[0])
        if score > 0:
            return "B+" + "%.1f" % score
        if score < 0:
            return "W+" + "%.1f" % abs(score)
        return "DRAW"

    def to_sgf(self) -> str:
        return sgf_lib.make_sgf(
            board_size=self.board_size,
            move_history=self.history,
            result_string=self.get_result_string(),
            ruleset="Chinese",
            komi=self.komi,
            date=get_time_stamp(),
        )


class GomokuEnv(_HostEnv):
    """Freestyle Gomoku; black 1, white 2."""

    def __init__(self, board_size: int = 13, num_to_win: int = 5, num_stack: int = 8,
                 device="cuda") -> None:
        engine = GomokuEngine(board_size=board_size, num_stack=num_stack,
                              num_to_win=num_to_win)
        self.num_to_win = num_to_win
        super().__init__(engine, black_player_id=1, white_player_id=2,
                         id="Freestyle Gomoku", device=device)

    def get_result_string(self) -> str:
        if not self.is_game_over():
            return ""
        if self.winner == self.black_player:
            return "B+1.0"
        if self.winner == self.white_player:
            return "W+1.0"
        return "DRAW"

    def to_sgf(self) -> str:
        return sgf_lib.make_sgf(
            board_size=self.board_size,
            move_history=self.history,
            result_string=self.get_result_string(),
            ruleset="",
            komi="",
            date=get_time_stamp(),
        )
