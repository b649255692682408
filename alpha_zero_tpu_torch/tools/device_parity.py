"""Engine parity sweep: the batched engine on a device against the CPU.

The port of ``tools/device_parity.py``. Identical random legal games step
through ``step_batch`` on the device and on the CPU, at several batch
sizes, and every analysis field is diffed after every step. A CPU-only
test cannot catch a miscompile or a kernel fault that shows only on one
backend at large batches; the JAX package found one this way (writes
dropped at batch >= 1024).

The moves are the JAX tool's: lane by lane from ``np.random.default_rng(B)``,
uniform over the legal board points of the CPU state (passes and the
resign move never drawn), the pass index ``N*N`` when none is legal. A
given B plays the same games as the JAX tool.
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.gomoku import GomokuEngine
from alpha_zero_tpu_torch.envs.types import GameState
from alpha_zero_tpu_torch.utils.device import resolve_device

# The fields diffed after every step, in the JAX tool's order: the first
# that differs is the one it would name.
FIELDS = {
    "go": ("board", "labels", "group_libs", "legal", "ko", "to_play",
           "pass_streak", "done", "winner"),
    "gomoku": ("board", "legal", "to_play", "done", "winner"),
}
BATCHES = (256, 1024, 2048, 4096)


def build_sweep_engine(game: str, board_size: int):
    """The engine the JAX tool builds for ``game``."""
    if game == "go":
        return GoEngine(board_size=board_size, num_stack=8)
    return GomokuEngine(board_size=board_size, num_stack=8)


def random_moves(rng: np.random.Generator, legal: np.ndarray, n_moves: int) -> np.ndarray:
    """One move a lane: uniform over the legal board points of ``legal``
    [B, A], else ``n_moves`` (the pass index)."""
    return np.array([rng.choice(np.flatnonzero(row[:n_moves] > 0.5))
                     if row[:n_moves].sum() else n_moves for row in legal], np.int32)


def lockstep(engine, ref_engine, batch: int, steps: int,
             device) -> Iterator[Tuple[int, np.ndarray, GameState, GameState]]:
    """Steps ``batch`` random games through ``engine`` on ``device`` and
    ``ref_engine`` on the CPU; yields ``(step, moves, device state, CPU
    state)`` after each step."""
    dev = resolve_device(device)
    n_moves = ref_engine.board_size ** 2
    rng = np.random.default_rng(batch)
    s_dev = engine.init_batch(batch, device=dev)
    s_cpu = ref_engine.init_batch(batch, device="cpu")
    for j in range(steps):
        moves = random_moves(rng, s_cpu.legal.numpy(), n_moves)
        s_dev = engine.step_batch(s_dev, torch.from_numpy(moves).to(dev))
        s_cpu = ref_engine.step_batch(s_cpu, torch.from_numpy(moves))
        yield j, moves, s_dev, s_cpu


def first_difference(s_dev: GameState, s_cpu: GameState, fields) -> Optional[Tuple[str, int]]:
    """``(field, lanes that differ)`` of the first field in ``fields`` that
    differs, or None."""
    for f in fields:
        a = getattr(s_dev, f).cpu().numpy()
        c = getattr(s_cpu, f).numpy()
        if not np.array_equal(a, c):
            return f, int((a != c).reshape(a.shape[0], -1).any(-1).sum())
    return None


def sweep(game: str, board_size: int, batches=BATCHES, steps: int = 12,
          device="cuda", engine=None) -> List[dict]:
    """One result a batch size: ``{"batch", "steps", "ok", "step", "field",
    "lanes", "captures", "ko", "done"}``. ``step``, ``field`` and ``lanes``
    name the first divergence (None when ``ok``). ``captures`` counts the
    stones captured on the CPU at the last step played, ``ko`` the moves
    that left a ko point, ``done`` the finished games. ``engine`` is the
    engine on ``device`` (by default the one the JAX tool builds); the
    reference is always that engine on the CPU. Raises when there is
    nothing to compare (no batch size, no step)."""
    if not batches or steps < 1:
        raise ValueError("the sweep needs at least one batch size and one step")
    dev = resolve_device(device)
    ref_engine = build_sweep_engine(game, board_size)
    engine = engine or ref_engine
    fields = FIELDS[game]
    results = []
    for batch in batches:
        bad, ko, played = None, 0, 0
        for j, _, s_dev, s_cpu in lockstep(engine, ref_engine, batch, steps, dev):
            played = j + 1
            ko += int((s_cpu.ko >= 0).sum())
            diff = first_difference(s_dev, s_cpu, fields)
            if diff:
                bad = (j,) + diff
                break
        step, field, lanes = bad or (None, None, None)
        results.append({
            "batch": batch, "steps": played, "ok": bad is None,
            "step": step, "field": field, "lanes": lanes,
            "captures": int(s_cpu.captures.sum()), "ko": ko,
            "done": int(s_cpu.done.sum())})
    return results


def result_line(r: dict) -> str:
    """The JAX tool's line for one batch size."""
    if r["ok"]:
        return f"B={r['batch']}: OK ({r['steps']} steps, all fields bit-equal)"
    return f"B={r['batch']}: DIVERGED step {r['step']} field {r['field']} ({r['lanes']} lanes)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--game", default="go", choices=("go", "gomoku"))
    p.add_argument("--board-size", type=int, default=9)
    p.add_argument("--batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    results = sweep(args.game, args.board_size, args.batches, args.steps, args.device)
    for r in results:
        print(result_line(r))
    return 0 if all(r["ok"] for r in results) else 1
