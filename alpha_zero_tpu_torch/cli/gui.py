"""Tk GUI board client — human-vs-AI and AI-vs-AI.

The port of ``alpha_zero_tpu.cli.gui``, with the same geometry, drawing,
header, events, SGF save and ``root.after``-driven game loop: a rendered
Go/Gomoku board with star points and coordinate labels, click-to-move,
pass/resign buttons (Go), new-game, save-SGF, a last-move marker, capture
counts and the match score in the header.

The board is a host env (``envs/host.py``, one game on ``device``); the AI
side is the evaluator's deterministic move function, a search on the same
device. ``tkinter`` is imported when a ``BoardGameGui`` is made, so a
machine without a display fails there, as the JAX package does.
"""

from __future__ import annotations

import os

CELL = 46
MARGIN = 40
STONE_R = 19


class BoardGameGui:
    """env: a host GoEnv/GomokuEnv; players: 'human' or move callables."""

    def __init__(self, env, black_player="human", white_player="human",
                 delay_ms: int = 300, save_sgf_dir: str = "./sgf_games") -> None:
        import tkinter as tk

        self.tk = tk
        self.env = env
        self.black_player = black_player
        self.white_player = white_player
        self.delay_ms = delay_ms
        self.save_sgf_dir = save_sgf_dir
        self.match_score = {"B": 0, "W": 0}
        self.game_over_announced = False

        n = env.board_size
        size = 2 * MARGIN + (n - 1) * CELL
        self.root = tk.Tk()
        self.root.title(f"AlphaZero TPU — {env.id}")
        self.header = tk.Label(self.root, font=("Helvetica", 13), pady=6)
        self.header.pack()
        self.canvas = tk.Canvas(self.root, width=size, height=size, bg="#d6a35c")
        self.canvas.pack()
        self.canvas.bind("<Button-1>", self.click_on_board)

        bar = tk.Frame(self.root)
        bar.pack(pady=4)
        if env.has_pass_move:
            tk.Button(bar, text="Pass", command=self.on_pass).pack(side=tk.LEFT, padx=4)
        if env.has_resign_move:
            tk.Button(bar, text="Resign", command=self.on_resign).pack(side=tk.LEFT, padx=4)
        tk.Button(bar, text="New game", command=self.new_game).pack(side=tk.LEFT, padx=4)
        tk.Button(bar, text="Save SGF", command=self.save_sgf).pack(side=tk.LEFT, padx=4)

        self.draw_board()
        self.update_header()

    # -- geometry -----------------------------------------------------------
    def _xy(self, row: int, col: int):
        return MARGIN + col * CELL, MARGIN + row * CELL

    def _nearest_intersection(self, x: float, y: float):
        col = round((x - MARGIN) / CELL)
        row = round((y - MARGIN) / CELL)
        n = self.env.board_size
        if 0 <= row < n and 0 <= col < n:
            return row, col
        return None

    # -- drawing ------------------------------------------------------------
    def draw_board(self) -> None:
        c = self.canvas
        c.delete("all")
        n = self.env.board_size
        end = MARGIN + (n - 1) * CELL
        for i in range(n):
            x, y = self._xy(i, 0)
            c.create_line(MARGIN, y, end, y)
            x, y = self._xy(0, i)
            c.create_line(x, MARGIN, x, end)
        # Star points.
        if n >= 9:
            pts = [3, n // 2, n - 4] if n >= 13 else [2, n // 2, n - 3]
            for r in pts:
                for cl in pts:
                    x, y = self._xy(r, cl)
                    c.create_oval(x - 3, y - 3, x + 3, y + 3, fill="black")
        # Coordinate labels (GTP style).
        for i in range(n):
            x, y = self._xy(n - 1, i)
            c.create_text(x, end + 22, text=self.env.gtp_columns[i], font=("Helvetica", 9))
            x, y = self._xy(i, 0)
            c.create_text(MARGIN - 22, y, text=str(n - i), font=("Helvetica", 9))

        board = self.env.board
        black_color = self.env._id_to_color(self.env.black_player)
        last = (self.env.action_to_coords(self.env.last_move)
                if self.env.last_move is not None else (-1, -1))
        for r in range(n):
            for cl in range(n):
                v = board[r, cl]
                if v == 0:
                    continue
                x, y = self._xy(r, cl)
                fill = "black" if v == black_color else "white"
                c.create_oval(x - STONE_R, y - STONE_R, x + STONE_R, y + STONE_R,
                              fill=fill, outline="gray20")
                if (r, cl) == last:
                    mark = "white" if fill == "black" else "black"
                    c.create_oval(x - 5, y - 5, x + 5, y + 5, outline=mark, width=2)

    def update_header(self) -> None:
        env = self.env
        to_move = "Black" if env.to_play == env.black_player else "White"
        caps = env.get_captures() if hasattr(env, "get_captures") else None
        parts = [f"Match B {self.match_score['B']} : {self.match_score['W']} W"]
        if env.is_game_over():
            parts.append(f"Game over — {env.get_result_string()}")
        else:
            parts.append(f"{to_move} to move (step {env.steps})")
        if caps:
            parts.append(f"captures B:{caps[env.black_player]} W:{caps[env.white_player]}")
        self.header.config(text="   |   ".join(parts))

    # -- events -------------------------------------------------------------
    def _active_player(self):
        return self.black_player if self.env.to_play == self.env.black_player else self.white_player

    def click_on_board(self, event) -> None:
        if self.env.is_game_over() or self._active_player() != "human":
            return
        coords = self._nearest_intersection(event.x, event.y)
        if coords is None:
            return
        action = self.env.coords_to_action(coords)
        if action is None or not self.env.is_legal_move(action):
            return
        self.make_move(action)

    def on_pass(self) -> None:
        if not self.env.is_game_over() and self._active_player() == "human":
            self.make_move(self.env.pass_move)

    def on_resign(self) -> None:
        if not self.env.is_game_over() and self._active_player() == "human":
            self.make_move(self.env.resign_move)

    def make_move(self, action: int) -> None:
        self.env.step(action)
        self.draw_board()
        self.update_header()

    def new_game(self) -> None:
        self.env.reset()
        self.game_over_announced = False
        self.draw_board()
        self.update_header()

    def save_sgf(self) -> None:
        os.makedirs(self.save_sgf_dir, exist_ok=True)
        from alpha_zero_tpu_torch.utils.logging import get_time_stamp

        path = os.path.join(self.save_sgf_dir, f"gui_{get_time_stamp(True)}.sgf")
        with open(path, "w") as f:
            f.write(self.env.to_sgf())

    # -- loop ---------------------------------------------------------------
    def play(self) -> None:
        if self.env.is_game_over():
            if not self.game_over_announced:
                self.game_over_announced = True
                result = self.env.get_result_string()
                if result.startswith("B+"):
                    self.match_score["B"] += 1
                elif result.startswith("W+"):
                    self.match_score["W"] += 1
                self.update_header()
        else:
            player = self._active_player()
            if callable(player):
                action = player(self.env)
                if action is not None:
                    self.make_move(action)
        self.root.after(self.delay_ms, self.play)

    def start(self) -> None:
        self.root.after(self.delay_ms, self.play)
        self.root.mainloop()


def gui_play(cfg, ckpt_path: str, human_is_black: bool = True,
             ai_vs_ai: bool = False, device="cuda") -> None:
    """Builds the env + AI player(s) on ``device`` and starts the GUI."""
    from alpha_zero_tpu_torch.cli.play import build_host_env, load_variables
    from alpha_zero_tpu_torch.eval.evaluator import make_eval_move_fn
    from alpha_zero_tpu_torch.training.pipeline import build_engine

    engine = build_engine(cfg.env)
    net = load_variables(cfg, ckpt_path, device)
    move_fn = make_eval_move_fn(engine, cfg.search)
    env = build_host_env(cfg, device)

    def ai_player(host_env):
        _, move = move_fn(net, host_env.state)
        return int(move)

    if ai_vs_ai:
        black, white = ai_player, ai_player
    elif human_is_black:
        black, white = "human", ai_player
    else:
        black, white = ai_player, "human"

    gui = BoardGameGui(env, black_player=black, white_player=white)
    gui.start()
