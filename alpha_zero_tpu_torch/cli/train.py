"""``python -m alpha_zero_tpu_torch.cli.train`` — the config-driven trainer.

The port of ``alpha_zero_tpu.cli.train``: pick a named config (go9 /
go19_jumbo / gomoku13 / gomoku9) and override any field with
``--set a.b.c=value``. Runs on ``--device`` (default ``cuda``). The
per-checkpoint evaluator runs unless ``--no-eval``: latest-vs-previous games
and Elo per checkpoint, plus pro-game metrics when ``run.eval_games_dir``
is set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from alpha_zero_tpu_torch.cli.common import add_config_args, resolve_config
from alpha_zero_tpu_torch.training import pipeline
from alpha_zero_tpu_torch.utils.logging import create_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(parser)
    parser.add_argument("--no-eval", action="store_true",
                        help="skip the per-checkpoint evaluator")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    cfg = resolve_config(args.config, args.set)
    logger = create_logger(cfg.run.log_level)
    logger.info("config: %s", json.dumps(dataclasses.asdict(cfg), default=str, indent=1))
    trainer = pipeline.Trainer(cfg, device=args.device)
    if not args.no_eval:
        trainer.enable_evaluator()
    trainer.run()


if __name__ == "__main__":
    main()
