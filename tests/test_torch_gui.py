"""Parity of the port's Tk GUI (``cli/gui.py``) and its ``cli.play`` flags
with the JAX package's.

Both GUIs import ``tkinter`` inside ``BoardGameGui.__init__``, so both run
here under the same recording stand-in (``chip_smoke.fake_tkinter``):

- one sequence of events (legal and illegal clicks, a click off the board,
  pass, resign, new game, save SGF, the game-over announcement) on 9x9 Go
  and 9x9 Gomoku: the recorded canvas calls and header texts equal, and
  the saved SGF files equal;
- ``gui_play(..., ai_vs_ai=True)`` on go9 with a 2 x 16 float32 net (the
  port's weights from the Flax ones through ``params_from_flax``) and 16
  simulations: the same 4 moves and the same drawing as the JAX GUI's;
- ``cli.play --gui`` / ``--ai_vs_ai`` reach ``gui_play``; with no display
  the port's ``--ai_vs_ai`` fails where the JAX one does, at ``tkinter.Tk``.
"""

import dataclasses
import itertools
import os
import sys
import tkinter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.cli import gui as jax_gui
from alpha_zero_tpu.cli import play as jax_play
from alpha_zero_tpu.envs import host as jax_host
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.utils import logging as jax_logging
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.cli import gui
from alpha_zero_tpu_torch.cli import play
from alpha_zero_tpu_torch.envs import host
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.utils import logging as port_logging

from torch_parity import one_torch_thread  # noqa: F401

STAMP = "2026-01-02 03:04:05"
SMALL = ["network.num_res_blocks=2", "network.num_filters=16", "network.num_fc_units=16",
         "network.inference_dtype=float32", "search.num_simulations=16"]


@pytest.fixture
def fixed_time(monkeypatch):
    """Both packages' SGF dates from one fixed time, and each package's SGF
    file names numbered from 0."""
    for module in (jax_logging, jax_host, port_logging, host):
        saves = itertools.count()
        monkeypatch.setattr(module, "get_time_stamp", lambda file_name=False, saves=saves:
                            f"{next(saves):08d}" if file_name else STAMP)


def _click(tk, row, col, dx=0, dy=0):
    x, y = gui.MARGIN + col * gui.CELL + dx, gui.MARGIN + row * gui.CELL + dy
    tk.bindings["<Button-1>"](SimpleNamespace(x=x, y=y))


def _go_events(tk):
    for row, col, dx in ((2, 2, 7), (6, 6, -9), (2, 6, 0), (6, 2, 12)):
        _click(tk, row, col, dx, -dx)
    _click(tk, 2, 2)                      # occupied: illegal, ignored
    _click(tk, 4, 4, 400, 0)              # off the board, ignored
    _click(tk, 3, 2)
    tk.buttons["Save SGF"]()
    tk.buttons["Pass"]()
    tk.buttons["Pass"]()                  # two passes: white wins on komi
    _click(tk, 4, 4)                      # game over: ignored
    tk.run_pending()                      # the loop announces the result
    tk.run_pending()                      # ... once
    tk.buttons["Save SGF"]()
    tk.buttons["New game"]()
    _click(tk, 4, 4)
    _click(tk, 4, 5)
    _click(tk, 5, 5)
    tk.buttons["Resign"]()                # white resigns
    tk.run_pending()
    tk.buttons["Save SGF"]()


def _gomoku_events(tk):
    for col in range(4):
        _click(tk, 0, col)
        _click(tk, 1, col)
    _click(tk, 1, 1)                      # occupied
    _click(tk, -2, 3)                     # off the board
    _click(tk, 0, 4)                      # five in a row: black wins
    tk.run_pending()
    tk.buttons["Save SGF"]()
    tk.buttons["New game"]()
    _click(tk, 4, 4)
    tk.run_pending()
    tk.buttons["Save SGF"]()


def _drive(make_env, events, monkeypatch, sgf_dir, gui_cls):
    tk = chip_smoke.fake_tkinter()
    monkeypatch.setitem(sys.modules, "tkinter", tk)
    board_gui = gui_cls(make_env(), save_sgf_dir=str(sgf_dir))
    board_gui.root.after(board_gui.delay_ms, board_gui.play)
    events(tk)
    files = sorted(os.listdir(sgf_dir))
    return tk.calls, board_gui.match_score, [(f, (sgf_dir / f).read_text()) for f in files]


@pytest.mark.parametrize("game", ["go", "gomoku"])
def test_gui_events_like_jax(game, monkeypatch, tmp_path, fixed_time):
    if game == "go":
        envs = (lambda: jax_host.GoEnv(board_size=9, komi=7.5, num_stack=2),
                lambda: host.GoEnv(board_size=9, komi=7.5, num_stack=2, device="cpu"))
        events = _go_events
    else:
        envs = (lambda: jax_host.GomokuEnv(board_size=9, num_stack=2),
                lambda: host.GomokuEnv(board_size=9, num_stack=2, device="cpu"))
        events = _gomoku_events
    ref = _drive(envs[0], events, monkeypatch, tmp_path / "jax", jax_gui.BoardGameGui)
    out = _drive(envs[1], events, monkeypatch, tmp_path / "port", gui.BoardGameGui)
    assert out[0] == ref[0]
    assert out[1] == ref[1] == ({"B": 1, "W": 1} if game == "go" else {"B": 1, "W": 0})
    assert out[2] == ref[2] and len(out[2]) == (3 if game == "go" else 2)
    headers = [kw["text"] for name, _, kw in out[0] if name == "config"]
    assert any("Game over" in h for h in headers)
    assert sum(name == "delete" for name, _, _ in out[0]) > 10


def _small_cfg(lib):
    cfg = lib.go9()
    net = dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                              num_fc_units=16, inference_dtype="float32")
    return dataclasses.replace(cfg, network=net,
                               search=dataclasses.replace(cfg.search, num_simulations=16))


def test_gui_play_ai_vs_ai_like_jax(monkeypatch):
    cfg_j, cfg = _small_cfg(jax_config), _small_cfg(config_lib)
    flax_net = jax_build_network(cfg_j.env, cfg_j.network)
    obs = jnp.zeros((1, 9, 9, cfg_j.env.num_planes), jnp.int8)
    variables = flax_net.init(jax.random.PRNGKey(5), obs, train=False)
    net = build_network(cfg.env, cfg.network, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    monkeypatch.setattr(jax_play, "load_variables", lambda c, p: (flax_net, variables))
    monkeypatch.setattr(play, "load_variables", lambda c, p, d: net)

    runs = []
    for gui_play, kw in ((jax_gui.gui_play, {}), (gui.gui_play, {"device": "cpu"})):
        tk = chip_smoke.fake_tkinter(4)
        monkeypatch.setitem(sys.modules, "tkinter", tk)
        gui_play(cfg_j if not kw else cfg, "", ai_vs_ai=True, **kw)
        runs.append((tk.calls, [(m.color, m.move) for m in tk.gui.env.history]))
    (ref_calls, ref_moves), (calls, moves) = runs
    assert moves == ref_moves and len(moves) == 4
    assert calls == ref_calls
    assert [c for c, _ in moves] == ["B", "W", "B", "W"]


def test_play_flags_reach_gui_play(monkeypatch):
    seen = []
    monkeypatch.setattr(gui, "gui_play", lambda *a, **k: seen.append((a, k)))
    play.main(["--gui", "--device", "cpu", "--ckpt", "x"])
    play.main(["--ai_vs_ai", "--white", "--config", "gomoku9", "--device", "cpu"])
    (a1, k1), (a2, k2) = seen
    assert a1[0].env.board_size == 9 and a1[0].env.game == "go" and a1[1] == "x"
    assert k1 == {"human_is_black": True, "ai_vs_ai": False, "device": "cpu"}
    assert a2[0].env.game == "gomoku" and a2[1] == ""
    assert k2 == {"human_is_black": False, "ai_vs_ai": True, "device": "cpu"}


def test_ai_vs_ai_without_a_display_fails_like_jax(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setitem(sys.modules, "tkinter", tkinter)
    sets = [x for v in SMALL for x in ("--set", v)]
    with pytest.raises(tkinter.TclError) as ref:
        jax_play.main(["--ai_vs_ai"] + sets)
    with pytest.raises(tkinter.TclError) as out:
        play.main(["--ai_vs_ai", "--device", "cpu"] + sets)
    assert str(out.value) == str(ref.value)
