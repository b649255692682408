"""Convert a JAX package (orbax) checkpoint into a PyTorch port checkpoint.

    python tools/ckpt_to_torch.py [--ckpt logs/go/9x9/ckpt_20000] [--config go9]
                                  [--out checkpoints/torch/go/9x9]

Restores the orbax checkpoint with ``alpha_zero_tpu.training.checkpoint``
into a ``TrainState`` of the named config, converts it with
``alpha_zero_tpu_torch.training.checkpoint.train_state_from_flax``
(float32 weights, BN statistics, the momentum trace, the step) and writes
it as ``<out>/training_steps_{t}``, which ``cli.train --set
run.load_ckpt=...`` resumes from. Needs JAX (on the CPU is enough); the
port itself never reads orbax. ``checkpoints/`` is not committed.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from alpha_zero_tpu import config as jax_config  # noqa: E402
from alpha_zero_tpu.models.resnet import build_network  # noqa: E402
from alpha_zero_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from alpha_zero_tpu.training import learner as jax_learner  # noqa: E402
from alpha_zero_tpu_torch import config as config_lib  # noqa: E402
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="logs/go/9x9/ckpt_20000", help="orbax checkpoint dir")
    p.add_argument("--config", default="go9", choices=sorted(config_lib.CONFIGS))
    p.add_argument("--out", default="checkpoints/torch/go/9x9", help="output directory")
    args = p.parse_args(argv)

    cfg = jax_config.get_config(args.config)
    n = cfg.env.board_size
    tx, _ = jax_learner.make_optimizer(
        cfg.train.init_lr, cfg.train.lr_decay, cfg.train.lr_milestones,
        momentum=cfg.train.sgd_momentum, weight_decay=cfg.train.l2_regularization)
    template = jax_learner.create_train_state(
        build_network(cfg.env, cfg.network), jax.random.PRNGKey(0),
        (n, n, cfg.env.num_planes), tx)
    state = jax_ckpt.restore_checkpoint(args.ckpt, template)
    tree = jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "training_steps": state.training_steps})

    port_cfg = config_lib.get_config(args.config)
    port_state = ckpt_lib.train_state_from_flax(tree, port_cfg.env, port_cfg.network,
                                                port_cfg.train, device="cpu")
    os.makedirs(args.out, exist_ok=True)
    path = ckpt_lib.save_checkpoint(args.out, port_state, port_state.training_steps)
    params = sum(x.numel() for x in port_state.net.parameters())
    print(f"{args.ckpt} (step {port_state.training_steps}, {params} parameters) -> {path}")
    return path


if __name__ == "__main__":
    main()
