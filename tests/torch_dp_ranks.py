"""Rank bodies for the data- and model-parallel tests of the PyTorch port
(not a test file). Each runs in a process of its own, spawned by
``tests/test_torch_parallel.py`` or ``tests/test_torch_model_axis.py``, or
started by ``cli.train`` for ``tests/test_torch_multihost.py`` and
``tests/test_torch_model_axis.py``, and writes what it saw under a
directory the test reads. They import torch and the port only: no JAX.
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
from alpha_zero_tpu_torch.models.resnet import (AlphaZeroNet, build_network,
                                                gather_state_dict, shard_state_dict,
                                                to_inference_dtype)
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.parallel.dryrun import digest
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner
from alpha_zero_tpu_torch.training import selfplay as selfplay_lib

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
        (loss,) = multihost.average_gradients([], [w], torch.tensor(float(rank)))
        got["averaged_grad"], got["averaged_loss"] = w.grad.flatten().tolist(), loss.item()
        multihost.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(got, f)
    finally:
        multihost.shutdown()


def model_collectives(rank: int, world: int, address: str, out_dir: str) -> None:
    """The model axis's collectives at dp=2 x mdl=2 with rank-dependent
    inputs: ``all_gather_channels`` and ``copy_to_model`` forward and
    backward, ``gather_slices``, and the data group's ``global_sum``,
    ``all_reduce_sum``, ``broadcast_tensors`` and ``average_gradients``;
    the results go to ``out_dir/rank{r}.json``."""
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, "cpu", 2)
    try:
        got = {"mesh": list(multihost.mesh()),
               "coords": [multihost.dp_index(), multihost.mdl_index()]}
        x = torch.tensor([[10.0 * rank, 10.0 * rank + 1]], requires_grad=True)
        y = multihost.all_gather_channels(x, 1)
        (3 * y * torch.arange(1.0, 5.0)).sum().backward()
        got["gathered"], got["gather_grad"] = y.tolist(), x.grad.flatten().tolist()
        x = torch.tensor([rank + 1.0], requires_grad=True)
        y = multihost.copy_to_model(x)
        (0.5 * y * y).sum().backward()
        got["copied"], got["copy_grad"] = y.tolist(), x.grad.tolist()
        got["whole"] = multihost.gather_slices(
            torch.tensor([2.0 * rank, 2.0 * rank + 1]), 0).tolist()
        got["global_sum"] = multihost.global_sum([multihost.dp_index() + 1, 1]).tolist()
        got["all_reduce_sum"] = multihost.all_reduce_sum(torch.tensor(10.0 * rank)).item()
        t = torch.tensor([float(rank)])
        multihost.broadcast_tensors([t])
        got["broadcast_tensors"] = t.tolist()
        sharded, replicated = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(2))
        sharded.grad, replicated.grad = torch.full((2,), float(rank)), torch.full((2,), float(rank))
        (loss,) = multihost.average_gradients([sharded], [replicated], torch.tensor(float(rank)))
        got["averaged"] = [sharded.grad.tolist(), replicated.grad.tolist(), loss.item()]
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


def _no_model_sum(x):
    """``copy_to_model`` without its backward sum over the model group: what
    a column-parallel layer must not do."""
    return x


def dp_step(rank: int, world: int, address: str, work_dir: str, fault=None, mdl: int = 1,
            dtype: str = "float32") -> None:
    """One train step (compute ``dtype``) on a mesh of ``mdl`` ranks a model
    group, from ``work_dir/init`` (a checkpoint) on this model group's rows
    of ``work_dir/batch.npz``; writes the state after it in the whole layout
    (``rank{r}/training_steps_1``), the losses (``rank{r}.json``) and a
    digest of the gathered state (``rank{r}.digest``). ``fault`` breaks the
    step: ``"local_moments"`` (each rank's own BatchNorm moments) or
    ``"no_model_sum"`` (``copy_to_model`` without its backward sum)."""
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, "cpu", mdl)
    try:
        if fault == "local_moments":
            resnet.batch_moments = _local_moments
        elif fault == "no_model_sum":
            multihost.copy_to_model = _no_model_sum
        env, net_cfg, train_cfg = equivalence_configs()
        state = learner.create_train_state(
            build_network(env, net_cfg, device="cpu", dtype="float32", mesh=multihost.mesh()),
            train_cfg)
        ckpt_lib.restore_checkpoint(os.path.join(work_dir, "init", "training_steps_0"), state)
        batch = np.load(os.path.join(work_dir, "batch.npz"))
        rows = len(batch["values"]) // multihost.mesh().dp
        lo, hi = multihost.dp_index() * rows, (multihost.dp_index() + 1) * rows
        step = learner.make_train_step(dtype, argument_data=True)
        metrics = step(state, *(torch.from_numpy(batch[k][lo:hi])
                                for k in ("states", "pis", "values")), int(batch["tid"]))
        path = ckpt_lib.save_checkpoint(os.path.join(work_dir, f"rank{rank}"), state, 1)
        with open(os.path.join(work_dir, f"rank{rank}.digest"), "w") as f:
            f.write(digest(torch.load(path, weights_only=True)["net"]))
        with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
            json.dump([float(metrics.policy_loss), float(metrics.value_loss)], f)
    finally:
        multihost.shutdown()


def mdl_forward(rank: int, world: int, address: str, work_dir: str, mdl: int) -> None:
    """The forward pass of this rank's part of the net in ``work_dir/net.json``
    (``AlphaZeroNet`` keyword arguments) with the whole-layout weights of
    ``work_dir/net.pt``, in float32 and in bf16 (``to_inference_dtype``), on
    ``work_dir/obs.npy``; writes the outputs and the gathers a forward pass
    made to ``rank{r}.pt``."""
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, "cpu", mdl)
    try:
        with open(os.path.join(work_dir, "net.json")) as f:
            kwargs = json.load(f)
        net = AlphaZeroNet(**kwargs, mdl=mdl)
        net.load_state_dict(shard_state_dict(
            torch.load(os.path.join(work_dir, "net.pt")), multihost.mesh(),
            multihost.mdl_index()))
        obs = torch.from_numpy(np.load(os.path.join(work_dir, "obs.npy")))
        out = {"sharded": sorted(net.sharded_names())}
        for dtype in ("float32", "bfloat16"):
            calls = multihost.all_gather_channels.calls
            with torch.no_grad():
                o = to_inference_dtype(net, dtype).eval()(obs)
            out[dtype] = (o.pi_logits, o.value)
            out["gathers"] = multihost.all_gather_channels.calls - calls
        torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def selfplay_config():
    """A tiny float32 Go net and search for the self-play replica test: 5x5
    Go, 2 stacked planes, 2 blocks x 16 filters, 8 simulations with reuse
    and ``max_new_sims=6``, resign off."""
    cfg = config_lib.AlphaZeroConfig(
        env=config_lib.EnvConfig(game="go", board_size=5, num_stack=2),
        network=config_lib.NetworkConfig(num_res_blocks=2, num_filters=16, num_fc_units=16,
                                         inference_dtype="float32"),
        search=config_lib.SearchConfig(num_simulations=8, warm_up_steps=2,
                                       reuse_subtree=True, max_new_sims=6),
        resign=config_lib.ResignConfig(init_resign_threshold=-1.0))
    return cfg


def play(cfg, net, games: int, moves: int, seed: int):
    """``moves`` self-play steps of ``games`` games with ``net`` on the CPU,
    draws from a generator seeded with ``seed``; returns the moves of each
    step and the final self-play state."""
    from alpha_zero_tpu_torch.training.pipeline import build_engine

    engine = build_engine(cfg.env)
    step = selfplay_lib.make_selfplay_step(engine, net, cfg.search, cfg.resign, device="cpu")
    generator = torch.Generator().manual_seed(seed)
    sp = selfplay_lib.init_selfplay_state(
        engine, games, generator, resign_threshold=-1.0, disable_resign_ratio=0.1,
        reuse_num_simulations=cfg.search.num_simulations, device="cpu")
    played = []
    for _ in range(moves):
        sp, out = step(sp, generator, -1.0)
        played.append(out.move)
    return torch.stack(played), sp


def mdl_selfplay(rank: int, world: int, address: str, work_dir: str, games: int,
                 moves: int) -> None:
    """``play`` with this rank's part of ``selfplay_config``'s net (seed 0,
    the model axis over all ranks); writes the moves, the final games and
    trees to ``rank{r}.pt``."""
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, "cpu", world)
    try:
        cfg = selfplay_config()
        net = build_network(cfg.env, cfg.network, device="cpu", seed=0, mesh=multihost.mesh())
        played, sp = play(cfg, net, games, moves, seed=3)
        torch.save({"moves": played, "games": sp.games, "trees": sp.trees,
                    "digest": digest(played, sp.games, sp.trees)},
                   os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def record_trainer(trainer) -> None:
    """``cli.train``'s ``prepare`` hook: counts the rank's self-play steps,
    records each exit from self-play (steps so far, the count returned, the
    global game count), and after the run saves the rank's train state and
    self-play net in the whole layout (``logs_dir/rank{r}/training_steps_{t}``
    and ``play_net.pt``; gathered over the model group, so every rank saves
    at the same point) and a summary ``logs_dir/rank{r}.json`` with digests
    of its games, trees, replay rows and weights (a model group's replicas
    must agree)."""
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
        path = ckpt_lib.save_checkpoint(out, trainer.train_state, trainer.training_steps)
        play_net = gather_state_dict(trainer.play_net)
        torch.save(play_net, os.path.join(out, "play_net.pt"))
        replay = trainer.replay
        with open(out + ".json", "w") as f:
            json.dump({"rank": trainer.rank, "world": trainer.world,
                       "dp_index": trainer.dp_index, "mdl_index": trainer.mdl_index,
                       "digests": {
                           "games": digest(trainer.sp_state.games),
                           "trees": digest(trainer.sp_state.trees),
                           "replay": digest(replay.states[:replay.size],
                                            replay.pi_probs[:replay.size],
                                            replay.values[:replay.size]),
                           "weights": digest(torch.load(path, weights_only=True)["net"],
                                             play_net)},
                       "training_steps": trainer.training_steps, "exits": exits,
                       "global_games_added": trainer.global_games_added,
                       "local_games": trainer.replay.num_games_added,
                       "local_samples": trainer.replay.num_samples_added,
                       "games_a_step": trainer.sp_state.games.done.shape[0],
                       "has_evaluator": trainer.evaluator is not None}, f)

    trainer.selfplay_step, trainer.selfplay_until, trainer.run = counted, recorded, run_and_record
