"""The engine parity sweep (``alpha_zero_tpu_torch/tools/device_parity.py``)
against the JAX tool ``tools/device_parity.py``.

- Its move stream and its CPU engine equal the JAX tool's loop (the same
  ``default_rng(B)`` draws into the JAX package's ``step_batch`` on the
  CPU), every listed field after every step, for 9x9 Go and Gomoku at
  B = 8 and 64.
- A stand-in engine that corrupts one field at one step makes ``sweep``
  name that step, that field and that lane count, and ``main`` return 1.
- Without CUDA, ``main([])`` raises, where the JAX tool returns 0 without
  an accelerator.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.go import GoEngine as JaxGoEngine
from alpha_zero_tpu.envs.gomoku import GomokuEngine as JaxGomokuEngine
from alpha_zero_tpu_torch.tools import device_parity

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12


def _jax_loop(game, board_size, batch, steps):
    """The JAX tool's loop (``tools/device_parity.py:64-77``) on the CPU
    alone: yields the moves and the state after each step."""
    cls = JaxGoEngine if game == "go" else JaxGomokuEngine
    engine = cls(board_size=board_size, num_stack=8)
    n_moves = board_size * board_size
    step = jax.jit(engine.step_batch)
    state = engine.init_batch(batch)
    rng = np.random.default_rng(batch)
    for _ in range(steps):
        legal = np.asarray(state.legal)
        mv = np.array(
            [rng.choice(np.flatnonzero(legal[i][:n_moves] > 0.5))
             if legal[i][:n_moves].sum() else n_moves
             for i in range(batch)], np.int32,
        )
        state = step(state, jnp.asarray(mv))
        yield mv, state


@pytest.mark.parametrize("game", ["go", "gomoku"])
@pytest.mark.parametrize("batch", [8, 64])
def test_moves_and_cpu_engine_follow_the_jax_tool(game, batch):
    engine = device_parity.build_sweep_engine(game, 9)
    port = device_parity.lockstep(engine, engine, batch, STEPS, "cpu")
    played = 0
    for (j, moves, s_dev, s_cpu), (ref_moves, ref) in zip(
            port, _jax_loop(game, 9, batch, STEPS)):
        np.testing.assert_array_equal(moves, ref_moves)
        for f in device_parity.FIELDS[game]:
            want = np.asarray(getattr(ref, f))
            for got in (s_dev, s_cpu):
                np.testing.assert_array_equal(getattr(got, f).numpy(), want,
                                              err_msg=f"step {j} {f}")
        played += 1
    assert played == STEPS
    (r,) = device_parity.sweep(game, 9, [batch], STEPS, "cpu")
    assert r["ok"] and r["steps"] == STEPS and r["field"] is None


class _Corrupting:
    """Go 9x9 whose ``ko`` field is wrong in three lanes after step 5."""

    def __init__(self):
        self.engine = device_parity.build_sweep_engine("go", 9)
        self.steps = 0

    def init_batch(self, batch, device):
        self.steps = 0
        return self.engine.init_batch(batch, device=device)

    def step_batch(self, state, moves):
        state = self.engine.step_batch(state, moves)
        self.steps += 1
        if self.steps == 6:
            ko = state.ko.clone()
            ko[[1, 3, 4]] = 99
            state = state.replace(ko=ko)
        return state


def test_a_corrupted_field_is_named(monkeypatch, capsys):
    results = device_parity.sweep("go", 9, [8, 16], STEPS, "cpu", engine=_Corrupting())
    for r, batch in zip(results, (8, 16)):
        assert (r["batch"], r["ok"], r["step"], r["field"], r["lanes"], r["steps"]) == (
            batch, False, 5, "ko", 3, 6)
    monkeypatch.setattr(device_parity, "sweep",
                        functools.partial(device_parity.sweep, engine=_Corrupting()))
    assert device_parity.main(["--batches", "8", "--device", "cpu"]) == 1
    assert capsys.readouterr().out == "B=8: DIVERGED step 5 field ko (3 lanes)\n"
    monkeypatch.undo()
    assert device_parity.main(["--batches", "8", "16", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ("B=8: OK (12 steps, all fields bit-equal)\n"
                                       "B=16: OK (12 steps, all fields bit-equal)\n")


def test_without_cuda_main_raises_where_the_jax_tool_passes(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    spec = importlib.util.spec_from_file_location(
        "jax_device_parity", os.path.join(REPO, "tools", "device_parity.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr("sys.argv", ["device_parity.py"])
    assert tool.main() == 0  # the JAX tool's trap: nothing compared
    assert "no accelerator devices found" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        device_parity.main([])
    with pytest.raises(ValueError):
        device_parity.sweep("go", 9, [], STEPS, "cpu")
