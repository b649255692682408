"""``python -m alpha_zero_tpu_torch.cli.train`` — the config-driven trainer.

The port of ``alpha_zero_tpu.cli.train``: pick a named config (go9 /
go19_jumbo / gomoku13 / gomoku9) and override any field with
``--set a.b.c=value``. Runs on ``--device`` (default ``cuda``). The
per-checkpoint evaluator runs unless ``--no-eval``: latest-vs-previous games
and Elo per checkpoint, plus pro-game metrics when ``run.eval_games_dir``
is set.

Data and model parallel, two ways:

- ``--set parallel.dp=k --set parallel.mdl=m`` (k * m > 1) starts k * m
  ranks on this host; rank r runs on ``cuda:{r % cards}``, or on the CPU
  with ``--device cpu``. The m consecutive ranks of a model group split
  the wide layers' output channels and play the same games; the k groups
  split ``parallel.selfplay_batch_size`` games;
- ``--set parallel.coordinator_address=host:port --set
  parallel.num_processes=n --set parallel.process_id=i`` makes this process
  rank i of n (n counts ranks, m of them a model group), and each model
  group plays ``selfplay_batch_size`` games of its own, as a JAX host with
  m chips does: start one on every card of every host, each with its own
  ``process_id``; rank 0 serves the address.

``train.batch_size`` is the global batch either way. The ranks talk over
NCCL when each has a card of its own and over gloo when they share one or
run on the CPU (``parallel/mesh.py:rank_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from alpha_zero_tpu_torch.cli.common import add_config_args, resolve_config
from alpha_zero_tpu_torch.ops import _build
from alpha_zero_tpu_torch.parallel import mesh as mesh_lib
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import pipeline
from alpha_zero_tpu_torch.utils.device import resolve_device
from alpha_zero_tpu_torch.utils.logging import create_logger


def _train(cfg, device, evaluate: bool, prepare) -> None:
    trainer = pipeline.Trainer(cfg, device=device)
    if evaluate:
        trainer.enable_evaluator()
    if prepare is not None:
        prepare(trainer)
    trainer.run()


def _rank(rank: int, cfg, device, evaluate: bool, prepare, address: str, world: int) -> None:
    """One rank: joins the process group at ``address`` (``world`` ranks,
    ``parallel.mdl`` a model group), trains on its device, leaves the
    group."""
    dev = multihost.initialize(address, world, rank, device, cfg.parallel.mdl)
    try:
        _train(cfg, dev, evaluate, prepare)
    finally:
        multihost.shutdown()


def main(argv=None, prepare=None) -> None:
    """Trains as the arguments say. ``prepare(trainer)``, when given, runs
    in every rank with its Trainer just before it trains; spawned ranks get
    it pickled, so it must be a module-level function."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(parser)
    parser.add_argument("--no-eval", action="store_true",
                        help="skip the per-checkpoint evaluator")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    cfg = resolve_config(args.config, args.set)
    par = cfg.parallel
    mesh = mesh_lib.make_mesh(
        par.num_processes if par.coordinator_address else par.dp * par.mdl, par.mdl)
    logger = create_logger(cfg.run.log_level)
    logger.info("config: %s", json.dumps(dataclasses.asdict(cfg), default=str, indent=1))
    evaluate = not args.no_eval
    if par.coordinator_address:
        _rank(par.process_id, cfg, args.device, evaluate, prepare,
              par.coordinator_address, par.num_processes)
    elif mesh.world > 1:
        if resolve_device(args.device).type == "cuda":
            _build.build_all()  # once, before the ranks load the kernels
        torch.multiprocessing.spawn(
            _rank, nprocs=mesh.world,
            args=(cfg, args.device, evaluate, prepare, multihost.local_address(), mesh.world))
    else:
        _train(cfg, args.device, evaluate, prepare)


if __name__ == "__main__":
    main()
