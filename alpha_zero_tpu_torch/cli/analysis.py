"""``python -m alpha_zero_tpu_torch.cli.analysis`` — model/search analysis tools.

The port of ``alpha_zero_tpu.cli.analysis``, with the same subcommands,
arguments and output:
- ``params``  — parameter counts per named config (``--device``)
- ``puct``    — PUCT exploration-rate curves
- ``aggregate-actors`` — merge actor CSVs (needs pandas)
- ``aggregate-matches`` — match logs -> Elo table (needs pandas)
- ``filter-sgf`` — copy SGFs passing dataset filters (``--device``)
- ``score-demo`` — dead-stone scoring limitation demo (``--device``)

``--device`` defaults to ``cuda``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil


def cmd_params(args) -> None:
    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.models.resnet import build_network, count_params
    from alpha_zero_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    for name in sorted(config_lib.CONFIGS):
        cfg = config_lib.get_config(name)
        net = build_network(cfg.env, cfg.network, device=dev)
        n = cfg.env.board_size
        print(f"{name:12s} board={n:2d} blocks={cfg.network.num_res_blocks:2d} "
              f"filters={cfg.network.num_filters:3d} params={count_params(net):,}")


def cmd_puct(args) -> None:
    """Prints the PUCT exploration coefficient vs visit count
    (pb_c = log((1+N+c_base)/c_base) + c_init, mcts_v2.py:99-102)."""
    c_base, c_init = args.c_puct_base, args.c_puct_init
    print(f"c_puct_base={c_base} c_puct_init={c_init}")
    for n in [0, 10, 100, 800, 5000, 20000, 100000, 500000]:
        pb_c = math.log((1 + n + c_base) / c_base) + c_init
        print(f"  N={n:7d}  pb_c={pb_c:.4f}")


def cmd_aggregate_actors(args) -> None:
    import pandas as pd

    frames = []
    for name in sorted(os.listdir(args.logs_dir)):
        if name.startswith("actor") and name.endswith(".csv"):
            frames.append(pd.read_csv(os.path.join(args.logs_dir, name)))
    if not frames:
        print("no actor CSVs found")
        return
    df = pd.concat(frames, ignore_index=True)
    out = os.path.join(args.logs_dir, "actors_aggregated.csv")
    df.to_csv(out, index=False)
    print(f"{len(df)} games -> {out}")
    print(f"mean game length: {df['game_length'].mean():.1f}")
    if "time_per_game" in df:
        print(f"mean time/game:  {df['time_per_game'].mean():.3f}s")
    results = df["game_result"].astype(str)
    print(f"black wins: {results.str.startswith('B+').sum()}, "
          f"white wins: {results.str.startswith('W+').sum()}")


def cmd_aggregate_matches(args) -> None:
    import pandas as pd

    from alpha_zero_tpu_torch.eval.elo import EloRating

    df = pd.read_csv(args.log_csv)
    ratings = {}
    for _, row in df.iterrows():
        b, w = str(row["black"]), str(row["white"])
        ratings.setdefault(b, EloRating(args.default_rating))
        ratings.setdefault(w, EloRating(args.default_rating))
        result = str(row["game_result"])
        if result.startswith("B+"):
            winner, loser = ratings[b], ratings[w]
        elif result.startswith("W+"):
            winner, loser = ratings[w], ratings[b]
        else:
            continue
        winner.update_rating(loser.rating, 1)
        loser.update_rating(winner.rating, 0)
    for name, elo in sorted(ratings.items(), key=lambda kv: -kv[1].rating):
        print(f"{elo.rating:8.1f}  {name}")


def cmd_filter_sgf(args) -> None:
    from alpha_zero_tpu_torch.eval.dataset import DatasetBuilder

    builder = DatasetBuilder(args.board_size, num_stack=2, min_elo=args.min_elo,
                             device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    kept = skipped = 0
    for root, _, files in os.walk(args.games_dir):
        for f in files:
            if not f.endswith(".sgf"):
                continue
            path = os.path.join(root, f)
            if builder.replay_sgf(path) is not None:
                shutil.copy(path, os.path.join(args.out_dir, f))
                kept += 1
            else:
                skipped += 1
    print(f"kept {kept}, skipped {skipped} -> {args.out_dir}")


# End-of-game positions where Tromp-Taylor area scoring mis-scores because
# dead stones are never removed (test data from others/go_score_system.py:
# board, komi, human-judged black/white scores). 1 = black, -1 = white.
_SCORE_DEMO_GAMES = [
    ("game 1 - incorrect score", 7.5, 44, 44.5, [
        "..XOO....", ".XXO.O...", ".X.XO.O..", "..XXOO...", "...OXXOO.",
        "..X.XXXO.", ".....XO.O", "...X.XOO.", "....XOO..",
    ]),
    ("game 2 - incorrect score", 7.5, 28, 60.5, [
        "....XXX..", ".XXXXOXXX", "X..XOOOOO", "XXXXOOOO.", "XOXOXXX.O",
        "OOXOOOOO.", "OOO.O.OOO", ".O.OXXXOX", "O.OXXXXXX",
    ]),
    ("game 3 - incorrect score", 7.5, 37, 51.5, [
        "....XXOOO", "....XOO.O", "....XXOOO", "XXX..XOO.", "XOOXXXOOO",
        "XXOXXXXOO", "XXOOXOO.O", "OOOOXOOXO", ".O.OOOOXO",
    ]),
    ("game 4 - incorrect winner", 7.0, 46, 42, [
        "..XOO....", "XX.XO.OO.", "X.XXOOXO.", ".XOOOXXXO", "XOXXOXXO.",
        "..XXXXOO.", "...O.XO..", "....XXO..", "....XOO..",
    ]),
    ("game 5 - incorrect winner", 7.0, 48, 40, [
        ".....XXO.", ".X...XO.O", "X...OXO..", "OXX..XO..", "OOX.XXOO.",
        "..OX.XOOO", ".OOOX.XXX", "O.OX.X...", "..OXX....",
    ]),
    ("game 6 - incorrect winner", 7.0, 39, 49, [
        ".OX......", "XOXX..X.X", "XOOX...XO", "X.OOXXXOO", "OOOXXOOO.",
        "OXXOOOX..", "XX.XOO...", "..XXXO...", "...XOO...",
    ]),
    ("game 7 - incorrect winner", 7.0, 43, 45, [
        ".OXX..X..", "OOOX.X.X.", ".OXXXXX..", "..OXXOX..", "..OOXOOX.",
        "...OOOOXX", ".XO.OOX..", ".O.OXOXXX", "O.OXXXXO.",
    ]),
]


def score_demo_areas(device="cuda"):
    """The demo boards' Tromp-Taylor areas (black, white; before komi),
    f32[7] each on ``device``: one batched ``GoEngine.area_counts`` call."""
    import numpy as np
    import torch

    from alpha_zero_tpu_torch.envs.go import GoEngine
    from alpha_zero_tpu_torch.utils.device import resolve_device

    boards = np.stack([
        np.array([[{"X": 1, "O": -1, ".": 0}[ch] for ch in row] for row in rows],
                 np.int8)
        for _, _, _, _, rows in _SCORE_DEMO_GAMES
    ])
    engine = GoEngine(board_size=9, num_stack=2)
    return engine.area_counts(torch.from_numpy(boards).to(resolve_device(device)))


def cmd_score_demo(args) -> None:
    """Scores all demo positions in ONE batched device call and shows why
    area scoring without dead-stone removal disagrees with human judgment
    (others/go_score_system.py:80-254)."""
    blacks, whites = score_demo_areas(args.device)
    for (name, komi, want_b, want_w, rows), b, w in zip(
        _SCORE_DEMO_GAMES, blacks.cpu().numpy(), whites.cpu().numpy()
    ):
        w = float(w) + komi
        computed = "B" if b > w else "W"
        expected = "B" if want_b > want_w else "W"
        print(f"\n{name} (komi {komi})")
        print("\n".join(rows))
        print(f"computed - black: {b:.1f}, white: {w:.1f}  (winner {computed})")
        print(f"expected - black: {want_b}, white: {want_w}  (winner {expected})")
    print("\nTromp-Taylor area scoring counts dead stones as alive; scores "
          "disagree with\nhuman judgment until both players capture dead "
          "groups or pass them out.")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "torch device to run on (default: cuda)"
    p = sub.add_parser("params")
    p.add_argument("--device", default="cuda", help=device_help)
    p = sub.add_parser("puct")
    p.add_argument("--c_puct_base", type=float, default=19652.0)
    p.add_argument("--c_puct_init", type=float, default=1.25)
    p = sub.add_parser("aggregate-actors")
    p.add_argument("--logs_dir", required=True)
    p = sub.add_parser("aggregate-matches")
    p.add_argument("--log_csv", required=True)
    p.add_argument("--default_rating", type=float, default=0.0)
    p = sub.add_parser("filter-sgf")
    p.add_argument("--games_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--board_size", type=int, default=9)
    p.add_argument("--min_elo", type=int, default=2100)
    p.add_argument("--device", default="cuda", help=device_help)
    p = sub.add_parser("score-demo")
    p.add_argument("--device", default="cuda", help=device_help)
    args = parser.parse_args(argv)
    {
        "params": cmd_params,
        "puct": cmd_puct,
        "aggregate-actors": cmd_aggregate_actors,
        "aggregate-matches": cmd_aggregate_matches,
        "filter-sgf": cmd_filter_sgf,
        "score-demo": cmd_score_demo,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
