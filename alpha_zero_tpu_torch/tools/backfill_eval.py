"""Offline re-evaluation of every saved checkpoint of a run.

The port of ``tools/backfill_eval.py``. Rebuilds a run's evaluation curve
from its checkpoints alone: per checkpoint, in step order, the evaluator's
row (latest-vs-previous games with Elo from a fresh chain, and the
pro-game metrics), or with ``metrics_only`` the pro-game metrics alone.
The in-run evaluator drops a checkpoint's row when its evaluation fails;
this writes a complete, consistent curve.

Each checkpoint is evaluated as the Trainer evaluates its master weights:
the checkpoint's float32 ``state_dict`` loaded into the Evaluator's nets,
which run in the config's inference dtype (BatchNorm float32). The
pro-game dataset is built on the device and cached as
``ckpt_dir/eval_dataset_{n}x{n}.npz``, the Trainer's cache, so a backfill
of a run reuses the run's. Rows have the JAX tool's columns.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Optional

import torch

from alpha_zero_tpu_torch.cli.common import resolve_config
from alpha_zero_tpu_torch.eval.dataset import build_eval_dataset
from alpha_zero_tpu_torch.eval.evaluator import Evaluator
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.training.checkpoint import list_checkpoints
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.csv_writer import CsvWriter
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import create_logger, get_time_stamp

# The pro-game metrics' batch in ``metrics_only`` mode (the JAX tool's).
METRICS_BATCH = 8192


def backfill(cfg, ckpt_dir: str, out: str, eval_games_dir: str = "",
             eval_games: int = 16, metrics_only: bool = False,
             steps: Optional[Iterable[int]] = None, device="cuda") -> int:
    """Writes one row a checkpoint of ``ckpt_dir`` (only the training steps
    in ``steps`` when given) to the CSV ``out``. Returns 0, or 1 when there
    is no checkpoint to evaluate."""
    dev = resolve_device(device)
    logger = create_logger()
    ckpts = list_checkpoints(ckpt_dir)
    if steps:
        keep = set(steps)
        ckpts = [(s, n) for s, n in ckpts if s in keep]
    if not ckpts:
        print("no checkpoints found")
        return 1
    if metrics_only and not eval_games_dir:
        raise ValueError("metrics_only needs the pro games (eval_games_dir)")

    n = cfg.env.board_size
    dataset = None
    if eval_games_dir:
        dataset = build_eval_dataset(
            eval_games_dir, n, cfg.env.num_stack, logger=logger,
            cache_path=os.path.join(ckpt_dir, f"eval_dataset_{n}x{n}.npz"), device=dev)
    evaluator = Evaluator(
        build_engine(cfg.env), build_network(cfg.env, cfg.network, device=dev, dtype="float32"),
        cfg.search, inference_dtype=cfg.network.inference_dtype, dataset=dataset,
        eval_games=1 if metrics_only else eval_games, device=dev)
    writer = CsvWriter(out, buffer_size=1)
    for step, name in ckpts:
        weights = torch.load(os.path.join(ckpt_dir, name), map_location=dev,
                             weights_only=True)["net"]
        if metrics_only:
            evaluator.latest_net.load_state_dict(weights)
            stats = evaluator._pro_metrics(batch_size=METRICS_BATCH)
        else:
            stats = evaluator.evaluate(weights, seed=step)
            stats.pop("_moves", None)
            stats.pop("_sgf_result", None)
        writer.write({"datetime": get_time_stamp(), "training_steps": step, **stats})
        logger.info(f"step {step}: " + ", ".join(
            f"{k}={v}" for k, v in stats.items()
            if k.startswith("policy_top_1") or k == "game_result"))
    writer.close()
    print(f"wrote {out} ({len(ckpts)} rows)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="go9")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--eval-games-dir", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--eval-games", type=int, default=16)
    p.add_argument("--metrics-only", action="store_true",
                   help="skip the matches/Elo; only pro-game metrics")
    p.add_argument("--steps", type=int, nargs="*", default=None,
                   help="only these training steps (default: all found)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return backfill(resolve_config(args.config, []), args.ckpt_dir, args.out,
                    args.eval_games_dir, args.eval_games, args.metrics_only,
                    args.steps, args.device)
