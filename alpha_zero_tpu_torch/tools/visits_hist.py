"""Root-visit distribution of self-play under subtree reuse.

The port of ``tools/visits_hist.py``. For each self-play move the root's
final visit count is N_root = carried visits + new simulations. The
reference's budget is ``while root.N < num_simulations``; with a
``max_new_sims`` cap below ``num_simulations - 1``, lanes whose reused
root carried few visits stop short of the full budget. ``root_visits``
collects N_root over steady-state moves and ``report`` prints its
distribution, so the strength cost of the cap is measured, not guessed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.device import resolve_device

# The histogram's bins and labels, as the JAX tool prints them.
EDGES = [0, 121, 140, 160, 180, 199, 10_000]
LABELS = ["<=120", "121-140", "141-160", "161-180", "181-199", ">=200"]


def with_reuse(cfg, max_new_sims: Optional[int] = None):
    """``cfg`` with subtree reuse on and ``max_new_sims`` (the config's
    own when None)."""
    search = dataclasses.replace(
        cfg.search, reuse_subtree=True,
        max_new_sims=cfg.search.max_new_sims if max_new_sims is None else max_new_sims)
    return dataclasses.replace(cfg, search=search)


def root_visits(cfg, batch: int, warm: int, steps: int, device="cuda",
                noise: Optional[Callable[[int], selfplay.SelfplayNoise]] = None,
                resign_u: Optional[torch.Tensor] = None,
                net: Optional[torch.nn.Module] = None) -> np.ndarray:
    """N_root of every game over ``steps`` self-play moves of ``batch``
    games after ``warm`` moves, resign off. ``cfg.search`` must reuse
    subtrees (``with_reuse``). The net is the config's with random weights
    of seed 0 in its inference dtype (BatchNorm float32) unless ``net`` is
    given. ``noise(i)`` gives move ``i``'s draws and ``resign_u`` the
    initial games' resign uniforms; both are drawn on ``device`` when
    absent."""
    dev = resolve_device(device)
    sims = cfg.search.num_simulations
    engine = build_engine(cfg.env)
    net = net if net is not None else build_network(cfg.env, cfg.network, device=dev, seed=0)
    step = selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = selfplay.init_selfplay_state(
        engine, batch, gen, resign_threshold=-1.0,
        disable_resign_ratio=cfg.resign.disable_resign_ratio,
        reuse_num_simulations=sims, resign_u=resign_u, device=dev)
    visits = []
    for i in range(warm + steps):
        sp, out = step(sp, gen, -1.0, noise=noise(i) if noise else None)
        if i >= warm:
            visits.append(out.root_visits.cpu().numpy())
    return np.concatenate(visits)


def report(v: np.ndarray, name: str, search_cfg, batch: int, warm: int) -> List[str]:
    """The JAX tool's report lines for the visit counts ``v``."""
    sims = search_cfg.num_simulations
    full = float((v >= sims).mean())
    lines = [
        f"config={name} sims={sims} max_new_sims={search_cfg.max_new_sims} "
        f"batch={batch} moves={v.size} (after {warm} warm steps)",
        f"N_root: mean={v.mean():.1f} median={np.median(v):.0f} "
        f"p10={np.percentile(v, 10):.0f} p25={np.percentile(v, 25):.0f} "
        f"p75={np.percentile(v, 75):.0f} min={v.min():.0f}",
        f"fraction reaching full budget ({sims}): {full:.3f}",
    ]
    hist, _ = np.histogram(v, bins=EDGES)
    for lab, h in zip(LABELS, hist):
        bar = "#" * int(60 * h / max(1, hist.max()))
        lines.append(f"{lab:>8}: {h / v.size:6.3f} {bar}")
    return lines


def main() -> None:
    """Reads ``B``, ``WARM``, ``STEPS``, ``MAX_NEW_SIMS``, ``CONFIG`` and
    ``DEVICE`` from the environment, as the JAX tool does (``DEVICE`` is
    the port's own, default ``cuda``), and prints the report."""
    batch = int(os.environ.get("B", "1024"))
    warm = int(os.environ.get("WARM", "50"))    # steps to reach steady state
    steps = int(os.environ.get("STEPS", "20"))  # measured steps
    name = os.environ.get("CONFIG", "go9")
    mns = os.environ.get("MAX_NEW_SIMS", "")
    cfg = with_reuse(config_lib.get_config(name), int(mns) if mns else None)
    v = root_visits(cfg, batch, warm, steps, os.environ.get("DEVICE", "cuda"))
    for line in report(v, name, cfg.search, batch, warm):
        print(line)
