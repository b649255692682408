"""The port's model axis (``parallel.mdl > 1``) on the CPU, against the JAX
package's ``('dp', 'mdl')`` mesh on the 8 virtual CPU devices. Ranks are
processes joined by gloo, each spawned with a timeout
(``tests/torch_dp_ranks.py``), so a hang fails one test.

- Shard decisions: every parameter of the go9 and gomoku13 nets at
  ``mdl`` 2 and 4, ``mesh.shard_spec`` against ``param_shardings``.
- The collectives of the model axis at dp=2 x mdl=2.
- Forward: the ``mdl=2`` net bit-equal to the whole one in float32 and
  bf16 (``params_from_flax`` weights), and within
  ``tests/test_torch_resnet.py``'s tolerances of the Flax net.
- Train step: one step at ``mdl=2`` and at dp=2 x mdl=2 against JAX's
  ``shard_train_state`` step on the same rows, to
  ``tests/test_parallel.py:72-76``'s tolerances in float32 and
  ``tests/test_multihost.py:102``'s in bf16; without ``copy_to_model``'s
  backward sum the float32 check fails.
- Self-play: ``mdl=2`` replicas play the ``mdl=1`` games move for move.
- The Trainer through ``cli.train`` at dp=2 x mdl=2, an ``mdl=1``
  checkpoint resumed by two coordinator ranks at ``mdl=2``, and
  ``dryrun_multichip(4, "cpu")``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from alpha_zero_tpu.config import get_config as jax_get_config
from alpha_zero_tpu.models.resnet import AlphaZeroNet as FlaxNet
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.parallel import mesh as jax_mesh_lib
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu_torch.cli import train as cli_train
from alpha_zero_tpu_torch.cli.common import resolve_config
from alpha_zero_tpu_torch.models.resnet import (AlphaZeroNet, build_network,
                                                params_from_flax, to_inference_dtype)
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.parallel.dryrun import digest
from alpha_zero_tpu_torch.parallel.mesh import shard_spec
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner, pipeline

import torch_dp_ranks
from test_torch_multihost import REPO, _argv, _launch, _restore, _rows, _sets, _wait
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import flax_variables, jax_np_state, jax_transform_id

G = 16  # the global train batch of the step tests


# ---------------------------------------------------------------------------
# Shard decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", ["go9", "gomoku13"])
@pytest.mark.parametrize("mdl", [2, 4])
def test_shard_decisions_match_jax_param_shardings(config, mdl):
    cfg = jax_get_config(config)
    net = jax_build_network(cfg.env, cfg.network)
    n = cfg.env.board_size
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, n, n, cfg.env.num_planes), jax.numpy.int8),
        train=False))["params"]
    specs = jax_mesh_lib.param_shardings(jax_mesh_lib.make_mesh(n_devices=mdl, mdl=mdl), shapes)
    # 1.0 where JAX shards the leaf over 'mdl', carried to the port's names.
    marks = jax.tree.map(lambda leaf, s: np.full(leaf.shape, float("mdl" in s.spec),
                                                 np.float32), shapes, specs)
    jax_sharded = {name for name, t in params_from_flax({"params": marks}).items()
                   if t.flatten()[0] == 1.0}
    whole = AlphaZeroNet(cfg.env.num_actions, n, cfg.env.num_planes,
                         cfg.network.num_res_blocks, cfg.network.num_filters,
                         cfg.network.num_fc_units, cfg.network.gomoku)
    full = dict(whole.named_parameters())
    assert {name for name, p in full.items() if shard_spec(name, p.shape, mdl) is not None} \
        == jax_sharded
    part = AlphaZeroNet(cfg.env.num_actions, n, cfg.env.num_planes,
                        cfg.network.num_res_blocks, cfg.network.num_filters,
                        cfg.network.num_fc_units, cfg.network.gomoku, mdl=mdl)
    assert part.sharded_names() == jax_sharded
    for name, p in part.named_parameters():
        want = list(full[name].shape)
        if name in jax_sharded:
            want[0] //= mdl
        assert list(p.shape) == want, name
    if config == "go9" and mdl == 2:  # the layers the issue names
        assert len(jax_sharded) == 24 and "policy_fc.weight" in jax_sharded
        assert not {"value_conv.weight", "value_fc2.weight", "policy_fc.bias"} & jax_sharded
    if config == "gomoku13":
        assert "policy_fc.weight" not in jax_sharded  # 169 outputs


# ---------------------------------------------------------------------------
# The collectives of the model axis
# ---------------------------------------------------------------------------


def test_model_collectives_at_dp2_mdl2(tmp_path):
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.model_collectives, 4, multihost.local_address(),
                               str(tmp_path))
    got = []
    for rank in range(4):
        with open(tmp_path / f"rank{rank}.json") as f:
            got.append(json.load(f))
    for rank, g in enumerate(got):
        dp_index, mdl_index = divmod(rank, 2)
        assert (g["mesh"], g["coords"]) == ([2, 2], [dp_index, mdl_index])
        # The model group's slices in rank order; the backward keeps this
        # rank's slice of the gradient, unsummed.
        assert g["gathered"] == [[10 * (2 * dp_index + m) + c for m in range(2) for c in range(2)]]
        assert g["gather_grad"] == [3.0 * (2 * mdl_index + c + 1) for c in range(2)]
        # copy_to_model: the identity, whose gradient sums the model group's.
        assert g["copied"] == [rank + 1.0]
        assert g["copy_grad"] == [sum(2 * dp_index + m + 1.0 for m in range(2))]
        # Data-group collectives: each model group once.
        assert g["global_sum"] == [sum(d + 1 for d in range(2)), 2]
        assert g["all_reduce_sum"] == sum(10.0 * (2 * d + mdl_index) for d in range(2))
        assert g["broadcast_tensors"] == [float(mdl_index)]
        assert g["whole"] == [float(r) for r in range(4 * dp_index, 4 * dp_index + 4)]
        # Slices over the data group, replicated tensors and losses over all.
        assert g["averaged"] == [[mdl_index + 1.0] * 2, [1.5] * 2, 1.5]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("board_size,gomoku,blocks,filters", [
    (9, False, 2, 128),  # go9's widths: 82 actions, 128 filters and value units
    (7, True, 1, 8),     # Gomoku stem; policy_fc (49) too narrow to split
])
def test_mdl2_forward_is_bit_equal_to_the_whole_net(tmp_path, board_size, gomoku, blocks,
                                                     filters):
    num_actions = board_size * board_size + (0 if gomoku else 1)
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 2, size=(8, board_size, board_size, 5)).astype(np.int8)
    flax_net = FlaxNet(num_actions=num_actions, num_res_blocks=blocks, num_filters=filters,
                       num_fc_units=filters, gomoku=gomoku)
    variables = flax_variables(flax_net, obs, seed=1)
    ref = flax_net.apply(variables, jax.numpy.asarray(obs), train=False)
    kwargs = dict(num_actions=num_actions, board_size=board_size, num_planes=5,
                  num_res_blocks=blocks, num_filters=filters, num_fc_units=filters,
                  gomoku=gomoku)
    full = params_from_flax(jax.tree.map(np.asarray, variables))
    torch.save(full, tmp_path / "net.pt")
    np.save(tmp_path / "obs.npy", obs)
    with open(tmp_path / "net.json", "w") as f:
        json.dump(kwargs, f)
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.mdl_forward, 2, multihost.local_address(),
                               str(tmp_path), 2)
    whole = AlphaZeroNet(**kwargs)
    whole.load_state_dict(full)
    want = {}
    for dtype in ("float32", "bfloat16"):
        with torch.no_grad():
            o = to_inference_dtype(whole, dtype).eval()(torch.from_numpy(obs))
        want[dtype] = (o.pi_logits, o.value)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["gathers"] == len(got["sharded"]) > 0  # one gather a sharded layer
        for dtype in ("float32", "bfloat16"):
            for w, g in zip(want[dtype], got[dtype]):
                assert float((w - g).abs().max()) == 0.0, (rank, dtype)
    logits, value = got["float32"]
    np.testing.assert_allclose(np.asarray(ref.pi_logits), logits.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.value), value.numpy(), rtol=0, atol=1e-5)
    logits, value = got["bfloat16"]
    np.testing.assert_allclose(np.asarray(ref.pi_logits), logits.numpy(), rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.asarray(ref.value), value.numpy(), rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# Train step against JAX's sharded step
# ---------------------------------------------------------------------------


def _jax_sharded_step(n_devices: int, dtype: str) -> dict:
    """The JAX package's step on the multihost worker's equivalence batch
    (``tests/test_torch_parallel.py:jax_single_step``'s net, seeds and 16
    rows), its train state placed by ``shard_train_state`` on
    ``make_mesh(n_devices, mdl=2)`` and the rows by ``batch_sharding``."""
    cfg = jax_get_config("gomoku9")
    env = dataclasses.replace(cfg.env, board_size=5, num_to_win=4, max_steps=25, num_stack=2)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8, num_fc_units=8,
                                  inference_dtype=dtype)
    net = jax_build_network(env, net_cfg)
    tx, schedule = jax_learner.make_optimizer(
        cfg.train.init_lr, cfg.train.lr_decay, cfg.train.lr_milestones,
        momentum=cfg.train.sgd_momentum, weight_decay=cfg.train.l2_regularization)
    state0 = jax_learner.create_train_state(net, jax.random.PRNGKey(123), (5, 5, 5), tx)
    init = jax_np_state(state0)
    mesh = jax_mesh_lib.make_mesh(n_devices=n_devices, mdl=2)
    state = jax_mesh_lib.shard_train_state(mesh, state0, tx)
    step = jax_learner.make_train_step(net, tx, schedule, argument_data=True)
    rng = np.random.default_rng(0)
    states = rng.integers(0, 2, size=(G, 5, 5, 5)).astype(np.int8)
    pis = rng.random((G, 25)).astype(np.float32)
    pis /= pis.sum(-1, keepdims=True)
    values = rng.choice([-1.0, 1.0], size=(G,)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    rows = jax_mesh_lib.batch_sharding(mesh)
    with mesh:
        state1, metrics = step(state, *(jax.device_put(x, rows) for x in (states, pis, values)),
                               key)
    return {"state0": init, "state1": jax_np_state(state1),
            "batch": dict(states=states, pis=pis, values=values, tid=jax_transform_id(key)),
            "losses": (float(metrics.policy_loss), float(metrics.value_loss))}


@pytest.fixture(scope="module")
def jax_steps():
    return {(n, dtype): _jax_sharded_step(n, dtype)
            for n, dtype in ((2, "float32"), (4, "float32"), (2, "bfloat16"))}


def _port_step(tmp_path, ref, world, fault=None, dtype="float32"):
    """The port's step on ``world`` ranks at ``mdl=2``: each rank's losses
    and its state after the step (whole layout), restored here."""
    env, net_cfg, train_cfg = torch_dp_ranks.equivalence_configs()
    init = ckpt_lib.train_state_from_flax(ref["state0"], env, net_cfg, train_cfg, device="cpu")
    ckpt_lib.save_checkpoint(str(tmp_path / "init"), init, 0)
    np.savez(tmp_path / "batch.npz", **ref["batch"])
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.dp_step, world, multihost.local_address(),
                               str(tmp_path), fault, 2, dtype)
    out = []
    for rank in range(world):
        with open(tmp_path / f"rank{rank}.json") as f:
            losses = json.load(f)
        state = learner.create_train_state(
            build_network(env, net_cfg, device="cpu", dtype="float32"), train_cfg)
        ckpt_lib.restore_checkpoint(str(tmp_path / f"rank{rank}" / "training_steps_1"), state)
        out.append((losses, state))
    return out


def _check_step(ref, losses, state) -> None:
    """``tests/test_parallel.py:72-76``'s check: losses to rtol 1e-5, then
    every parameter, BatchNorm statistic and momentum buffer to rtol 2e-4,
    atol 2e-5."""
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = state.net.state_dict()
    for name, value in params_from_flax(ref["state1"]).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=name)
    trace = params_from_flax({"params": ref["state1"]["opt_state"][1].trace})
    for name, param in state.net.named_parameters():
        np.testing.assert_allclose(state.optimizer.state[param]["momentum_buffer"].numpy(),
                                   trace[name].numpy(), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])  # mdl=2; dp=1 and dp=2
def test_mdl_step_matches_the_jax_sharded_step(tmp_path, jax_steps, world):
    ref = jax_steps[(world, "float32")]
    out = _port_step(tmp_path, ref, world)
    assert ref["batch"]["tid"] != 0  # the step runs a real transform
    for losses, state in out:
        _check_step(ref, losses, state)
        assert losses == out[0][0] and ckpt_lib.states_equal(state, out[0][1])
    digests = [(tmp_path / f"rank{r}.digest").read_text() for r in range(world)]
    assert digests == [digests[0]] * world


def test_mdl_step_in_bf16_tracks_the_jax_sharded_step(tmp_path, jax_steps):
    """bf16 compute: the losses within ``tests/test_multihost.py:102``'s
    1e-2 of JAX's bf16 step on the ``mdl=2`` mesh."""
    ref = jax_steps[(2, "bfloat16")]
    (losses0, state0), (losses1, state1) = _port_step(tmp_path, ref, 2, dtype="bfloat16")
    assert np.abs(np.subtract(losses0, ref["losses"])).max() < 1e-2
    assert losses0 == losses1 and ckpt_lib.states_equal(state0, state1)


def test_mdl_step_without_the_model_sum_fails_the_parity_check(tmp_path, jax_steps):
    """``copy_to_model`` without its backward all-reduce: every layer
    upstream of a sharded one gets part of its gradient, and the check
    above tells."""
    ref = jax_steps[(2, "float32")]
    (losses, state), _ = _port_step(tmp_path, ref, 2, fault="no_model_sum")
    with pytest.raises(AssertionError):
        _check_step(ref, losses, state)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)  # the forward is unchanged


# ---------------------------------------------------------------------------
# Self-play
# ---------------------------------------------------------------------------


def test_mdl2_selfplay_plays_the_mdl1_games(tmp_path):
    games, moves = 4, 6
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.mdl_selfplay, 2, multihost.local_address(),
                               str(tmp_path), games, moves)
    cfg = torch_dp_ranks.selfplay_config()
    net = build_network(cfg.env, cfg.network, device="cpu", seed=0)
    played, sp = torch_dp_ranks.play(cfg, net, games, moves, seed=3)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["digest"] == ranks[1]["digest"]  # the replicas, bit for bit
    got = ranks[0]
    assert torch.equal(got["moves"], played)
    assert digest(got["games"]) == digest(sp.games)
    assert digest(got["trees"]) == digest(sp.trees)
    assert (played >= 0).all() and int(sp.trees.num_nodes.max()) > 1


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def _summaries(tmp_path, world):
    out = []
    for r in range(world):
        with open(tmp_path / "logs" / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def _check_replicas(summaries, mdl):
    """A model group's ranks: the same exits, games, trees, replay rows and
    weights; every rank the same steps and global count."""
    s0 = summaries[0]
    for s in summaries:
        assert (s["dp_index"], s["mdl_index"]) == divmod(s["rank"], mdl)
        assert s["exits"] == s0["exits"] and s["training_steps"] == s0["training_steps"]
        assert s["global_games_added"] == s0["global_games_added"]
        assert s["digests"] == summaries[s["dp_index"] * mdl]["digests"]
        assert s["digests"]["weights"] == s0["digests"]["weights"]


def test_dp2_mdl2_trainer_run_through_cli(tmp_path):
    """``tests/test_parallel.py:140``'s micro run (Gomoku 5x5, 3 to win,
    1 block x 8 filters, 8 simulations, 8 games, 2 steps) at dp=2 x mdl=2:
    4 ranks, 4 games a model group."""
    sets = _sets(tmp_path, "parallel.dp=2", "parallel.mdl=2", "parallel.selfplay_batch_size=8",
                 "train.max_training_steps=2")
    _wait([_launch(_argv(sets, False))])
    summaries = _summaries(tmp_path, 4)
    _check_replicas(summaries, 2)
    s0, s2 = summaries[0], summaries[2]
    assert s0["world"] == 4 and s0["training_steps"] == 2
    assert [s["games_a_step"] for s in summaries] == [4] * 4
    assert s0["digests"]["games"] != s2["digests"]["games"]  # the groups' own games
    # Each game once: the global count is the model groups' games summed.
    assert s0["global_games_added"] == s0["local_games"] + s2["local_games"] >= 4
    logs, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    actors = [_rows(logs / f"actor{d}.csv") for d in (0, 1)]
    assert [len(a) for a in actors] == [s0["local_games"], s2["local_games"]]
    assert not (logs / "actor2.csv").exists() and not (logs / "actor3.csv").exists()
    rows = _rows(logs / "training.csv")
    assert int(rows[-1]["total_games"]) == s0["global_games_added"]
    # One checkpoint, in the whole layout: every rank's gathered state.
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("training_steps_")) == [
        "training_steps_2"]
    saved = _restore(ckpt / "training_steps_2")
    for r in range(4):
        assert ckpt_lib.states_equal(saved, _restore(logs / f"rank{r}" / "training_steps_2"))
    # Restored into an mdl=1 Trainer, bit for bit.
    single = pipeline.Trainer(resolve_config("gomoku9", _sets(
        tmp_path / "single", f"run.load_ckpt={ckpt}/training_steps_2")), device="cpu")
    assert single.train_state.net.sharded_names() == set()
    assert ckpt_lib.states_equal(single.train_state, saved)
    # The self-play net, gathered, is the master weights in its dtypes.
    play = torch.load(logs / "rank0" / "play_net.pt")
    assert all(torch.equal(play[k], v.to(play[k].dtype))
               for k, v in saved.net.state_dict().items())


def test_mdl1_checkpoint_resumes_under_mdl2_coordinator_ranks(tmp_path):
    """A single-process run to step 2, then two coordinator ranks with
    ``parallel.mdl=2`` (one model group of ``selfplay_batch_size`` games)
    on to step 4, with the evaluator (rank 0's, on a whole net); the
    ``mdl=2`` checkpoint restores in one process."""
    cli_train.main(_argv(_sets(tmp_path, "parallel.selfplay_batch_size=4",
                               "train.max_training_steps=2"), False))
    address = multihost.local_address()
    _wait([_launch(_argv(_sets(
        tmp_path, "parallel.selfplay_batch_size=4", "parallel.mdl=2",
        f"parallel.coordinator_address={address}", "parallel.num_processes=2",
        f"parallel.process_id={r}", f"run.load_ckpt={tmp_path}/ckpt/training_steps_2")))
        for r in (0, 1)])
    summaries = _summaries(tmp_path, 2)
    _check_replicas(summaries, 2)
    s0 = summaries[0]
    assert s0["training_steps"] == 4 and s0["games_a_step"] == 4
    assert s0["global_games_added"] == s0["local_games"]  # one model group
    assert not (tmp_path / "logs" / "actor1.csv").exists()
    assert (s0["has_evaluator"], summaries[1]["has_evaluator"]) == (True, False)
    assert [int(r["training_steps"]) for r in _rows(tmp_path / "logs" / "evaluation.csv")] == [4]
    final = _restore(tmp_path / "ckpt" / "training_steps_4")
    assert final.training_steps == 4
    assert ckpt_lib.states_equal(final, _restore(tmp_path / "logs" / "rank1" / "training_steps_4"))


def test_dryrun_multichip_on_four_cpu_ranks():
    """``python -m alpha_zero_tpu_torch.parallel.dryrun --ranks 4 --device
    cpu`` (``dryrun_multichip(4, "cpu")``, which raises unless the losses,
    the replicas and ``search_pi``'s shape hold) in a process group of its
    own, killed with its ranks if it outlasts ``test_torch_multihost``'s
    ``RUN_TIMEOUT_S``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "alpha_zero_tpu_torch.parallel.dryrun", "--ranks", "4",
         "--device", "cpu"], cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    (out,) = _wait([proc])
    assert "dryrun_multichip OK: mesh dp=2 mdl=2" in out
