"""``python -m alpha_zero_tpu_torch.cli.play`` — play against a trained agent.

The port of ``alpha_zero_tpu.cli.play``: a terminal game with GTP-style
input against the net of a port checkpoint (``training_steps_{t}``, as
``cli.train`` writes them; ``tools/ckpt_to_torch.py`` converts the JAX
package's orbax checkpoints). The agent searches without noise and plays
its most visited move. The human plays black unless ``--white``. ``--gui``
plays in the Tk GUI (``cli/gui.py``) instead, and ``--ai_vs_ai`` shows the
agent playing itself there. Runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from alpha_zero_tpu_torch.cli.common import add_config_args, resolve_config
from alpha_zero_tpu_torch.envs.host import GoEnv, GomokuEnv
from alpha_zero_tpu_torch.eval.evaluator import make_eval_move_fn
from alpha_zero_tpu_torch.models.resnet import build_network, to_inference_dtype
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import create_logger


def load_variables(cfg, ckpt_path: str, device="cuda") -> torch.nn.Module:
    """The net of ``cfg`` in eval mode and the config's inference dtype
    (BatchNorm float32), with the weights of the port checkpoint at
    ``ckpt_path``, or random weights of seed 0 when it is empty."""
    dev = resolve_device(device)
    net = build_network(cfg.env, cfg.network, device=dev, dtype="float32")
    if ckpt_path:
        payload = torch.load(ckpt_path, map_location=dev, weights_only=True)
        net.load_state_dict(payload["net"])
    return to_inference_dtype(net, cfg.network.inference_dtype).eval()


def build_host_env(cfg, device="cuda"):
    if cfg.env.game == "go":
        return GoEnv(board_size=cfg.env.board_size, komi=cfg.env.komi,
                     num_stack=cfg.env.num_stack, device=device)
    return GomokuEnv(board_size=cfg.env.board_size, num_to_win=cfg.env.num_to_win,
                     num_stack=cfg.env.num_stack, device=device)


def terminal_play(cfg, ckpt_path: str, human_is_black: bool, device="cuda") -> None:
    """The GTP-input terminal loop."""
    logger = create_logger()
    engine = build_engine(cfg.env)
    net = load_variables(cfg, ckpt_path, device)
    move_fn = make_eval_move_fn(engine, cfg.search)
    env = build_host_env(cfg, device)
    human = env.black_player if human_is_black else env.white_player
    env.reset()
    env.render()
    search_times = []
    while not env.is_game_over():
        if env.to_play == human:
            action = None
            while action is None:
                raw = input('Enter your move (e.g. "D4", "pass", "resign"): ').strip()
                if raw.lower() == "resign" and env.has_resign_move:
                    action = env.resign_move
                    break
                action = env.gtp_to_action(raw)
                if action is None:
                    print("Invalid or illegal move.")
            env.step(action)
        else:
            t0 = time.time()
            _, move = move_fn(net, env.state)
            search_times.append(time.time() - t0)
            env.step(int(move))
        env.render()
    logger.info(f"Result: {env.get_result_string()}")
    if search_times:
        logger.info(f"Avg time per AI move: {np.mean(search_times):.2f}s")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(parser)
    parser.add_argument("--ckpt", default="", help="checkpoint path (untrained net if empty)")
    parser.add_argument("--white", action="store_true", help="human plays white")
    parser.add_argument("--gui", action="store_true", help="use the Tk GUI")
    parser.add_argument("--ai_vs_ai", action="store_true",
                        help="watch the agent play itself (GUI)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = resolve_config(args.config, args.set)

    if args.gui or args.ai_vs_ai:
        from alpha_zero_tpu_torch.cli.gui import gui_play

        gui_play(cfg, args.ckpt, human_is_black=not args.white, ai_vs_ai=args.ai_vs_ai,
                 device=args.device)
    else:
        terminal_play(cfg, args.ckpt, human_is_black=not args.white, device=args.device)


if __name__ == "__main__":
    main()
