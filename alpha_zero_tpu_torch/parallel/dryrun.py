"""The multi-rank dry run: one full train step and one self-play step on a
``('dp', 'mdl')`` mesh of ranks, at tiny shapes.

The counterpart of ``__graft_entry__.dryrun_multichip``:

    python -m alpha_zero_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

spawns ``--ranks`` processes joined over gloo (``mdl = 2`` when the count
is even and at least 4, else 1), each on ``--device`` (all share one card
with ``cuda``). On 5x5 Go (2 stacked planes, a 2-block x 16-filter net, 16
value units, 6 simulations, 2 warm-up moves, subtree reuse) every model
group steps on its 2 rows of a global train batch of ``2 * dp`` (the wide
layers' output channels split over its ``mdl`` ranks) and plays one
self-play move of its 2 games. Every rank must report the same finite
losses, a model group's ranks the same digest of its gathered weights,
boards and trees, and the groups ``2 * dp`` rows of ``search_pi`` with
``num_actions`` columns; rank 0's OK line names the mesh.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import math

import numpy as np
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.envs.types import TensorStruct
from alpha_zero_tpu_torch.models.resnet import (build_network, gather_state_dict,
                                                to_inference_dtype)
from alpha_zero_tpu_torch.ops import _build, scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.ops.symmetry import random_transform_id
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.parallel.mesh import make_mesh
from alpha_zero_tpu_torch.training import learner
from alpha_zero_tpu_torch.training import selfplay as selfplay_lib
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils.device import resolve_device


def _leaves(x):
    if isinstance(x, (torch.Tensor, np.ndarray)):
        yield torch.as_tensor(x)
    elif isinstance(x, TensorStruct):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, dict):
        for key in x:
            yield from _leaves(x[key])
    else:
        for item in x:
            yield from _leaves(item)


def digest(*items) -> str:
    """SHA-256 of every tensor in ``items`` (tensors, numpy arrays, tensor
    structs such as games and trees, dicts and sequences of them), bytes,
    dtypes and shapes in order: equal digests mean bit-equal contents (the
    replica check)."""
    h = hashlib.sha256()
    for t in _leaves(items):
        t = t.detach().cpu().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dryrun_config() -> config_lib.AlphaZeroConfig:
    """``__graft_entry__.dryrun_multichip``'s configuration."""
    return config_lib.AlphaZeroConfig(
        env=config_lib.EnvConfig(game="go", board_size=5, num_stack=2),
        network=config_lib.NetworkConfig(num_res_blocks=2, num_filters=16, num_fc_units=16),
        search=config_lib.SearchConfig(num_simulations=6, warm_up_steps=2,
                                       reuse_subtree=True),
        train=dataclasses.replace(config_lib.TrainConfig(), init_lr=0.01, lr_decay=0.1,
                                  lr_milestones=(1000,)),
    )


def _rank(rank: int, world: int, mdl: int, address: str, device: str, results) -> None:
    """One rank of the dry run; puts its report on ``results``."""
    dev = multihost.initialize(address, world, rank, device, mdl)
    try:
        mesh = multihost.mesh()
        dp_index = multihost.dp_index()
        cfg = dryrun_config()
        engine = build_engine(cfg.env)
        n, a = cfg.env.board_size, engine.num_actions
        net = build_network(cfg.env, cfg.network, device=dev, seed=0, dtype="float32",
                            mesh=mesh)
        state = learner.create_train_state(net, cfg.train)

        # One full train step: 2 rows a model group of the global 2 * dp.
        rows = 2
        states = torch.zeros((rows, n, n, cfg.env.num_planes), dtype=torch.int8, device=dev)
        target_pi = torch.full((rows, a), 1.0 / a, device=dev)
        target_v = torch.zeros((rows,), device=dev)
        step = learner.make_train_step(cfg.network.inference_dtype, argument_data=True)
        metrics = step(state, states, target_pi, target_v,
                       random_transform_id(torch.Generator().manual_seed(1)))
        losses = [float(metrics.policy_loss), float(metrics.value_loss)]

        # One self-play step of this model group's 2 games.
        play_net = to_inference_dtype(copy.deepcopy(state.net),
                                      cfg.network.inference_dtype).eval()
        sp_step = selfplay_lib.make_selfplay_step(engine, play_net, cfg.search, cfg.resign,
                                                  device=dev)
        generator = torch.Generator(device=dev).manual_seed(2 + dp_index)
        sp = selfplay_lib.init_selfplay_state(
            engine, rows, generator, resign_threshold=-1.0, disable_resign_ratio=0.1,
            reuse_num_simulations=cfg.search.num_simulations, device=dev)
        select, writer = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
        select.launches = writer.launches = 0
        sp, out = sp_step(sp, generator, -1.0)
        launches = (select.launches, writer.launches)
        global_rows = multihost.global_game_count(out.search_pi.shape[0])
        weights = gather_state_dict(state.net)
        results.put({
            "rank": rank, "dp": mesh.dp, "mdl": mesh.mdl, "dp_index": dp_index,
            "losses": losses, "search_pi": [global_rows, out.search_pi.shape[1]],
            "num_actions": a, "move": int(out.move[0]), "launches": launches,
            "digest": digest(weights, sp.games, sp.trees)})
        multihost.barrier()
    finally:
        multihost.shutdown()


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """Runs the dry run over ``n_ranks`` spawned ranks; raises unless every
    rank's losses are finite and equal, every model group's replicas
    bit-equal and ``search_pi`` ``[2 * dp, num_actions]``. Prints the OK
    line and returns ``{"line", "dp", "mdl", "ranks": [each rank's
    report]}``."""
    mdl = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    mesh = make_mesh(n_ranks, mdl)
    if resolve_device(device).type == "cuda":
        _build.build_all()  # once, before the ranks load the kernels
    ranks = multihost.spawn_and_collect(
        _rank, n_ranks, (n_ranks, mdl, multihost.local_address(), str(device)))
    r0 = ranks[0]
    if not all(math.isfinite(x) for x in r0["losses"]):
        raise RuntimeError(f"dry run: the train step's losses are not finite: {r0['losses']}")
    if any(r["losses"] != r0["losses"] for r in ranks):
        raise RuntimeError(f"dry run: the ranks' losses differ: {[r['losses'] for r in ranks]}")
    if r0["search_pi"] != [2 * mesh.dp, r0["num_actions"]]:
        raise RuntimeError(f"dry run: search_pi rows x columns {r0['search_pi']}, expected "
                           f"{[2 * mesh.dp, r0['num_actions']]}")
    for r in ranks:
        if r["digest"] != ranks[r["dp_index"] * mdl]["digest"]:
            raise RuntimeError(f"dry run: rank {r['rank']} differs from its model group's "
                               "first rank (weights, boards or trees)")
    line = (f"dryrun_multichip OK: mesh dp={mesh.dp} mdl={mdl}, "
            f"train loss={r0['losses'][0]:.3f}, selfplay moves={r0['move']}...")
    print(line, flush=True)
    return {"line": line, "dp": mesh.dp, "mdl": mdl, "ranks": ranks}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4, help="number of ranks (default: 4)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every rank (default: cuda)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
