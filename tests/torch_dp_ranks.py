"""Rank bodies for the data-parallel tests of the PyTorch port (not a
test file). Each runs in a process of its own, spawned by
``tests/test_torch_parallel.py`` or started by ``cli.train`` for
``tests/test_torch_multihost.py``, and writes what it saw under a directory
the test reads. They import torch and the port only: no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os

import numpy as np
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner

SPAWN_TIMEOUT_S = 120


def spawn_ranks(target, world: int, *args) -> None:
    """Runs ``target(rank, world, *args)`` in ``world`` spawned processes;
    fails if one fails or the ranks have not all ended within
    ``SPAWN_TIMEOUT_S`` seconds (a rank that hangs in a collective)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + args) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def collectives(rank: int, world: int, address: str, out_dir: str) -> None:
    """Every collective of ``parallel.multihost`` once, with rank-dependent
    inputs; the results go to ``out_dir/rank{r}.json``."""
    torch.set_num_threads(1)
    dev = multihost.initialize(address, world, rank, "cpu")
    try:
        got = {"device": str(dev), "rank": multihost.rank(), "world": multihost.world_size(),
               "is_host0": multihost.is_host0(), "backend": torch.distributed.get_backend()}
        got["global_sum"] = multihost.global_sum([rank + 1, 10 * rank, 7]).tolist()
        got["global_game_count"] = multihost.global_game_count(rank + 3)
        got["broadcast"] = multihost.broadcast_from_host0(0.1 + rank)
        got["broadcast_int"] = multihost.broadcast_from_host0(2**40 + rank)
        t = torch.full((3,), float(rank))
        multihost.broadcast_tensors([t])
        got["broadcast_tensors"] = t.tolist()
        x = torch.tensor([rank + 1.0], requires_grad=True)
        y = multihost.all_reduce_sum(2 * x)
        (y * (rank + 1)).sum().backward()
        got["all_reduce_sum"], got["all_reduce_sum_grad"] = y.item(), x.grad.item()
        w = torch.nn.Parameter(torch.zeros(2, 2))
        w.grad = torch.full((2, 2), float(rank))
        (loss,) = multihost.average_gradients([w], torch.tensor(float(rank)))
        got["averaged_grad"], got["averaged_loss"] = w.grad.flatten().tolist(), loss.item()
        multihost.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(got, f)
    finally:
        multihost.shutdown()


def equivalence_configs():
    """The JAX multihost worker's equivalence net (``tests/multihost_worker.py``:
    gomoku9 at 5x5, 4 to win, 2 stacked planes, 1 block x 8 filters) in
    float32, as the port's ``(env, network, train)`` configs."""
    cfg = config_lib.gomoku9()
    env = dataclasses.replace(cfg.env, board_size=5, num_to_win=4, max_steps=25, num_stack=2)
    net = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8, num_fc_units=8,
                              inference_dtype="float32")
    return env, net, cfg.train


def _local_moments(xf):
    """This rank's batch only: what a data-parallel BatchNorm must not do."""
    mean = xf.mean(dim=(0, 2, 3))
    return mean, torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)


def dp_step(rank: int, world: int, address: str, work_dir: str, local_moments: bool) -> None:
    """One data-parallel train step from ``work_dir/init`` (a checkpoint)
    on this rank's rows of ``work_dir/batch.npz``; writes the state after
    it (``rank{r}/training_steps_1``) and the losses (``rank{r}.json``)."""
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, "cpu")
    try:
        if local_moments:
            resnet.batch_moments = _local_moments
        env, net_cfg, train_cfg = equivalence_configs()
        state = learner.create_train_state(
            build_network(env, net_cfg, device="cpu", dtype="float32"), train_cfg)
        ckpt_lib.restore_checkpoint(os.path.join(work_dir, "init", "training_steps_0"), state)
        batch = np.load(os.path.join(work_dir, "batch.npz"))
        rows = len(batch["values"]) // world
        lo, hi = rank * rows, (rank + 1) * rows
        step = learner.make_train_step("float32", argument_data=True)
        metrics = step(state, *(torch.from_numpy(batch[k][lo:hi])
                                for k in ("states", "pis", "values")), int(batch["tid"]))
        ckpt_lib.save_checkpoint(os.path.join(work_dir, f"rank{rank}"), state, 1)
        with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
            json.dump([float(metrics.policy_loss), float(metrics.value_loss)], f)
    finally:
        multihost.shutdown()


def record_trainer(trainer) -> None:
    """``cli.train``'s ``prepare`` hook: counts the rank's self-play steps,
    records each exit from self-play (steps so far, the count returned, the
    global game count), and after the run saves the rank's train state
    (``logs_dir/rank{r}/training_steps_{t}``), its self-play net and a
    summary ``logs_dir/rank{r}.json``."""
    steps, exits = [0], []
    step_fn, until, run = trainer.selfplay_step, trainer.selfplay_until, trainer.run

    def counted(*args, **kwargs):
        steps[0] += 1
        return step_fn(*args, **kwargs)

    def recorded(*args, **kwargs):
        n = until(*args, **kwargs)
        exits.append([steps[0], n, trainer.global_games_added])
        return n

    def run_and_record(*args, **kwargs):
        run(*args, **kwargs)
        out = os.path.join(trainer.cfg.run.logs_dir, f"rank{trainer.rank}")
        ckpt_lib.save_checkpoint(out, trainer.train_state, trainer.training_steps)
        torch.save(trainer.play_net.state_dict(), os.path.join(out, "play_net.pt"))
        with open(out + ".json", "w") as f:
            json.dump({"rank": trainer.rank, "world": trainer.world,
                       "training_steps": trainer.training_steps, "exits": exits,
                       "global_games_added": trainer.global_games_added,
                       "local_games": trainer.replay.num_games_added,
                       "local_samples": trainer.replay.num_samples_added,
                       "games_a_step": trainer.sp_state.games.done.shape[0],
                       "has_evaluator": trainer.evaluator is not None}, f)

    trainer.selfplay_step, trainer.selfplay_until, trainer.run = counted, recorded, run_and_record
