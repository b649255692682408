"""``python -m alpha_zero_tpu_torch.cli.plot`` — training dashboard from CSV logs.

A copy of ``alpha_zero_tpu.cli.plot`` (framework-free; the port keeps its
own copy rather than import the JAX package): a 4x3 matplotlib dashboard
(Agg backend) of self-play / training / evaluation, read from the CSV
schemas both packages write (``actor*.csv``, ``training.csv``,
``evaluation.csv``). It needs pandas and matplotlib and no torch; it runs
on the CPU only, wherever those two are installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd


def _maybe(path: str):
    if os.path.exists(path) and os.path.getsize(path) > 0:
        try:
            return pd.read_csv(path)
        except Exception:
            return None
    return None


def load_logs(logs_dir: str):
    actor_frames = []
    for name in sorted(os.listdir(logs_dir)):
        if name.startswith("actor") and name.endswith(".csv"):
            df = _maybe(os.path.join(logs_dir, name))
            if df is not None:
                actor_frames.append(df)
    actors = pd.concat(actor_frames, ignore_index=True) if actor_frames else None
    training = _maybe(os.path.join(logs_dir, "training.csv"))
    evaluation = _maybe(os.path.join(logs_dir, "evaluation.csv"))
    return actors, training, evaluation


def build_dashboard(logs_dir: str, out_file: str = "") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    actors, training, evaluation = load_logs(logs_dir)
    fig, axes = plt.subplots(4, 3, figsize=(18, 16))
    fig.suptitle(f"AlphaZero TPU dashboard — {logs_dir}", fontsize=14)

    col0 = axes[:, 0]
    col0[0].set_title("Self-play")
    if actors is not None and len(actors):
        idx = np.arange(len(actors))
        col0[0].plot(idx, actors["game_length"].rolling(200, min_periods=1).mean())
        col0[0].set_ylabel("game length (avg)")
        if "time_per_game" in actors:
            col0[1].plot(idx, actors["time_per_game"])
            col0[1].set_ylabel("time per game (s)")
        if "num_passes" in actors:
            col0[2].plot(idx, actors["num_passes"].rolling(200, min_periods=1).mean())
            col0[2].set_ylabel("passes per game (avg)")
        if "resign_threshold" in actors:
            col0[3].plot(idx, pd.to_numeric(actors["resign_threshold"], errors="coerce"))
            col0[3].set_ylabel("resign threshold")
        col0[3].set_xlabel("games")

    col1 = axes[:, 1]
    col1[0].set_title("Training")
    if training is not None and len(training):
        steps = training["training_steps"]
        col1[0].plot(steps, training["policy_loss"])
        col1[0].set_ylabel("policy loss")
        col1[1].plot(steps, training["value_loss"])
        col1[1].set_ylabel("value loss")
        col1[2].plot(steps, training["learning_rate"])
        col1[2].set_ylabel("learning rate")
        col1[3].plot(steps, training["total_games"])
        col1[3].set_ylabel("total games")
        col1[3].set_xlabel("training steps")

    col2 = axes[:, 2]
    col2[0].set_title("Evaluation")
    if evaluation is not None and len(evaluation):
        steps = evaluation["training_steps"]
        if "black_elo_rating" in evaluation:
            col2[0].plot(steps, evaluation["black_elo_rating"], label="black (latest)")
            col2[0].plot(steps, evaluation["white_elo_rating"], label="white (prev)")
            col2[0].set_ylabel("Elo")
            col2[0].legend()
        for k, style in (("policy_top_1_accuracy", "-"), ("policy_top_3_accuracy", "--"),
                         ("policy_top_5_accuracy", ":")):
            if k in evaluation:
                col2[1].plot(steps, evaluation[k], style, label=k.split("_")[2])
        col2[1].set_ylabel("pro-move top-k accuracy")
        col2[1].legend()
        if "value_mse_error" in evaluation:
            col2[2].plot(steps, evaluation["value_mse_error"])
            col2[2].set_ylabel("value MSE")
        if "policy_entropy" in evaluation:
            col2[3].plot(steps, evaluation["policy_entropy"])
            col2[3].set_ylabel("policy entropy")
        col2[3].set_xlabel("training steps")

    for ax in axes.ravel():
        ax.grid(alpha=0.3)
    fig.tight_layout(rect=[0, 0, 1, 0.97])
    out_file = out_file or os.path.join(logs_dir, "dashboard.png")
    fig.savefig(out_file, dpi=110)
    print(f"dashboard written to {out_file}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--logs_dir", required=True)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    build_dashboard(args.logs_dir, args.out)


if __name__ == "__main__":
    main()
