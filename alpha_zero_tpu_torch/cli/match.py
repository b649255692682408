"""``python -m alpha_zero_tpu_torch.cli.match`` — mass head-to-head matches.

The port of ``alpha_zero_tpu.cli.match``: two port checkpoints play
``--num_games`` games in lockstep on ``--device`` (default ``cuda``); one
``log.csv`` row and one ``game_{i}.sgf`` per game go to
``--save_match_dir``. ``--black_search`` / ``--white_search`` override a
side's search config (e.g. ``reuse_subtree=True``, ``max_new_sims=120``)
and switch to the asymmetric match, which carries trees across plies.
"""

from __future__ import annotations

import argparse
import os
import re

from alpha_zero_tpu_torch.cli.common import add_config_args, apply_override, resolve_config
from alpha_zero_tpu_torch.cli.play import load_variables
from alpha_zero_tpu_torch.eval.match import play_matches, play_matches_asym
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils import sgf as sgf_lib
from alpha_zero_tpu_torch.utils.csv_writer import CsvWriter
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import create_logger, get_time_stamp


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(parser)
    parser.add_argument("--black_ckpt", required=True)
    parser.add_argument("--white_ckpt", required=True)
    parser.add_argument("--num_games", type=int, default=32)
    parser.add_argument("--save_match_dir", default="./matches")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--black_search", action="append", default=[],
                        metavar="field=v",
                        help="per-side SearchConfig override for black "
                             "(repeatable), e.g. --black_search "
                             "reuse_subtree=True --black_search max_new_sims=120"
                             " — enables asymmetric matches (the subtree-reuse"
                             " strength measurement)")
    parser.add_argument("--white_search", action="append", default=[],
                        metavar="field=v", help="same for white")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = resolve_config(args.config, args.set)
    logger = create_logger()
    device = resolve_device(args.device)

    engine = build_engine(cfg.env)
    black_net = load_variables(cfg, args.black_ckpt, device)
    white_net = load_variables(cfg, args.white_ckpt, device)

    def side_cfg(overrides):
        sc = cfg.search
        for ov in overrides:
            field, raw = ov.split("=", 1)
            sc = apply_override(sc, field, raw)
        return sc

    black_cfg = side_cfg(args.black_search)
    white_cfg = side_cfg(args.white_search)
    asym = bool(args.black_search or args.white_search)

    os.makedirs(args.save_match_dir, exist_ok=True)
    writer = CsvWriter(os.path.join(args.save_match_dir, "log.csv"), 1)

    logger.info(f'Black: "{args.black_ckpt}"')
    logger.info(f'White: "{args.white_ckpt}"')
    logger.info(f"Playing {args.num_games} lockstep games on {device}...")

    if asym:
        logger.info(f"Asymmetric search: black={black_cfg} white={white_cfg}")
        stats = play_matches_asym(
            engine, black_cfg, white_cfg, black_net, white_net,
            num_games=args.num_games, seed=args.seed, record_moves=True, device=device,
        )
    else:
        stats = play_matches(
            engine, cfg.search, black_net, white_net,
            num_games=args.num_games, seed=args.seed, record_moves=True, device=device,
        )

    black_won = white_won = 0
    for item in stats:
        moves = item.pop("moves", [])
        item.pop("winner", None)
        row = {"datetime": get_time_stamp(), "black": args.black_ckpt,
               "white": args.white_ckpt, **item}
        writer.write(row)
        if re.match(r"B\+", item["game_result"], re.IGNORECASE):
            black_won += 1
        elif re.match(r"W\+", item["game_result"], re.IGNORECASE):
            white_won += 1
        content = sgf_lib.make_sgf(
            board_size=cfg.env.board_size,
            move_history=moves,
            result_string=item["game_result"],
            ruleset="Chinese" if cfg.env.game == "go" else "",
            komi=cfg.env.komi if cfg.env.game == "go" else "",
            date=get_time_stamp(),
        )
        with open(os.path.join(args.save_match_dir, f"game_{item['game']}.sgf"), "w") as f:
            f.write(content)

    writer.close()
    logger.info(
        f"Total games {args.num_games}, black won {black_won}, white won {white_won}"
    )


if __name__ == "__main__":
    main()
