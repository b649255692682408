"""The port's data-parallel layer (``alpha_zero_tpu_torch/parallel``) on the
CPU: ranks are processes on one host joined by gloo, each spawned with a
timeout (``tests/torch_dp_ranks.py``), so a hang fails one test.

- ``spawn_and_collect``: records in rank order, one larger than a pipe's
  buffer, a failing rank raising.
- The collectives: ``global_sum``, ``global_game_count``,
  ``broadcast_from_host0``, ``broadcast_tensors``, the differentiable
  ``all_reduce_sum`` and ``average_gradients``, at 2 and 3 ranks; the rank
  helpers and the collectives without a process group.
- The mesh: ``make_mesh`` at ``mdl`` 1 and 2 with JAX's rank layout, its
  error when ``mdl`` does not divide the ranks, the rank -> device map and
  the backend rule.
- DP step parity: the JAX multihost worker's equivalence batch (gomoku 5x5,
  1 block x 8 filters, seeds 123 / 7, 16 rows) in float32, 8 rows a rank.
  After one step both ranks' losses, parameters, BN running statistics and
  momentum buffers match ``learner.make_train_step`` of the JAX package on
  all 16 rows in one process within ``F32_ATOL`` (the bound
  ``tests/test_torch_learner.py`` holds float32 steps to), and the two
  ranks are bit-equal. The same step with each rank's own BN moments fails
  that bound.
- ``ResignController.on_games_global`` against the JAX package's on
  scripted counter streams.
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch

from alpha_zero_tpu.config import ResignConfig as JaxResignConfig
from alpha_zero_tpu.config import get_config as jax_get_config
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.parallel import mesh as jax_mesh_lib
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu.training.pipeline import ResignController as JaxResignController
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import params_from_flax
from alpha_zero_tpu_torch.parallel import mesh as mesh_lib
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import pipeline

import torch_dp_ranks
from torch_parity import jax_np_state, jax_transform_id

F32_ATOL = 1e-5  # tests/test_torch_learner.py's bound on float32 steps
G = 16           # the global batch; each of the 2 ranks steps on 8 rows


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbytes", [16, 4 << 20])
def test_spawn_and_collect_returns_records_by_rank(nbytes):
    """``multihost.spawn_and_collect`` returns each rank's record in rank
    order, also when a record outgrows a pipe's buffer (64 KiB), so that
    its ``put`` waits for the reader before the rank can end."""
    records = multihost.spawn_and_collect(torch_dp_ranks.put_record, 3, (nbytes, -1))
    assert [r["rank"] for r in records] == [0, 1, 2]
    for r in records:
        assert r["payload"].shape == (nbytes,) and (r["payload"] == r["rank"]).all()


def test_spawn_and_collect_raises_when_a_rank_fails():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 fails"):
        multihost.spawn_and_collect(torch_dp_ranks.put_record, 2, (16, 1))


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_sum_and_broadcast(tmp_path, world):
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.collectives, world,
                               multihost.local_address(), str(tmp_path))
    for rank in range(world):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert (got["rank"], got["world"], got["is_host0"]) == (rank, world, rank == 0)
        assert (got["device"], got["backend"]) == ("cpu", "gloo")
        assert got["global_sum"] == [sum(r + 1 for r in range(world)),
                                     sum(10 * r for r in range(world)), 7 * world]
        assert got["global_game_count"] == sum(r + 3 for r in range(world))
        assert got["broadcast"] == 0.1 and got["broadcast_int"] == 2**40
        assert got["broadcast_tensors"] == [0.0] * 3
        # y = sum_s 2 (s + 1); rank r's loss is (r + 1) y, so dx_r = 2 sum_s (s + 1).
        total = sum(r + 1 for r in range(world))
        assert got["all_reduce_sum"] == 2 * total
        assert got["all_reduce_sum_grad"] == 2 * total
        mean = sum(range(world)) / world
        assert got["averaged_grad"] == [mean] * 4 and got["averaged_loss"] == mean


def test_collectives_without_a_process_group_return_their_input():
    assert (multihost.rank(), multihost.world_size(), multihost.is_host0()) == (0, 1, True)
    np.testing.assert_array_equal(multihost.global_sum([3, 4]), [3, 4])
    assert multihost.global_game_count(5) == 5
    assert multihost.broadcast_from_host0(-0.88) == -0.88
    t = torch.ones(2)
    multihost.broadcast_tensors([t])
    multihost.barrier()
    assert torch.equal(t, torch.ones(2))


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------


def test_make_mesh_and_the_model_axis():
    assert mesh_lib.make_mesh(4) == mesh_lib.Mesh(dp=4, mdl=1)
    mesh = mesh_lib.make_mesh(8, mdl=2)
    assert mesh == mesh_lib.Mesh(dp=4, mdl=2) and mesh.world == 8
    # Rank r sits where JAX's make_mesh puts device r: (r // mdl, r % mdl).
    jax_mesh = jax_mesh_lib.make_mesh(n_devices=8, mdl=2)
    for r, device in enumerate(jax.devices()[:8]):
        (where,) = np.argwhere(jax_mesh.devices == device)
        assert mesh.coords(r) == tuple(where)
    with pytest.raises(ValueError, match="not divisible by mdl=2"):
        mesh_lib.make_mesh(3, mdl=2)
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(0)


@pytest.mark.parametrize("device,local_rank,ranks,cards,want", [
    ("cpu", 1, 2, 0, ("cpu", "gloo")),
    ("cuda", 0, 2, 1, ("cuda:0", "gloo")),   # two ranks share the one card
    ("cuda", 1, 2, 1, ("cuda:0", "gloo")),
    ("cuda", 1, 2, 2, ("cuda:1", "nccl")),   # a card each
    ("cuda", 5, 8, 8, ("cuda:5", "nccl")),
    ("cuda", 5, 12, 8, ("cuda:5", "gloo")),
    ("cuda:1", 0, 2, 4, ("cuda:1", "gloo")),  # an explicit card is shared
    ("cuda:1", 0, 1, 4, ("cuda:1", "nccl")),
])
def test_rank_device_and_backend(monkeypatch, device, local_rank, ranks, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    dev, backend = mesh_lib.rank_device(device, local_rank, ranks)
    assert (str(dev), backend) == want


# ---------------------------------------------------------------------------
# DP step parity with the JAX package's single-device step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_single_step():
    """The JAX package's step on all 16 rows in one process, as in
    ``tests/test_multihost.py:_single_process_losses`` but float32: the
    initial state, the batch, the transform id, the losses and the state
    after the step (numpy trees)."""
    cfg = jax_get_config("gomoku9")
    env = dataclasses.replace(cfg.env, board_size=5, num_to_win=4, max_steps=25, num_stack=2)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8, num_fc_units=8,
                                  inference_dtype="float32")
    net = jax_build_network(env, net_cfg)
    tx, schedule = jax_learner.make_optimizer(
        cfg.train.init_lr, cfg.train.lr_decay, cfg.train.lr_milestones,
        momentum=cfg.train.sgd_momentum, weight_decay=cfg.train.l2_regularization)
    state0 = jax_learner.create_train_state(net, jax.random.PRNGKey(123), (5, 5, 5), tx)
    step = jax_learner.make_train_step(net, tx, schedule, argument_data=True)
    rng = np.random.default_rng(0)
    states = rng.integers(0, 2, size=(G, 5, 5, 5)).astype(np.int8)
    pis = rng.random((G, 25)).astype(np.float32)
    pis /= pis.sum(-1, keepdims=True)
    values = rng.choice([-1.0, 1.0], size=(G,)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    init = jax_np_state(state0)  # before the step, which donates state0's buffers
    state1, metrics = step(state0, states, pis, values, key)
    return {"state0": init, "state1": jax_np_state(state1),
            "batch": dict(states=states, pis=pis, values=values, tid=jax_transform_id(key)),
            "losses": (float(metrics.policy_loss), float(metrics.value_loss))}


def _dp_step(tmp_path, ref, local_moments):
    """Runs the 2-rank step; returns each rank's losses and state."""
    env, net_cfg, train_cfg = torch_dp_ranks.equivalence_configs()
    init = ckpt_lib.train_state_from_flax(ref["state0"], env, net_cfg, train_cfg, device="cpu")
    ckpt_lib.save_checkpoint(str(tmp_path / "init"), init, 0)
    np.savez(tmp_path / "batch.npz", **ref["batch"])
    torch_dp_ranks.spawn_ranks(torch_dp_ranks.dp_step, 2, multihost.local_address(),
                               str(tmp_path), "local_moments" if local_moments else None)
    out = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            losses = json.load(f)
        state = torch_dp_ranks.learner.create_train_state(
            torch_dp_ranks.build_network(env, net_cfg, device="cpu", dtype="float32"), train_cfg)
        ckpt_lib.restore_checkpoint(str(tmp_path / f"rank{rank}" / "training_steps_1"), state)
        out.append((losses, state))
    return out


def _max_deviation(ref, losses, state) -> float:
    """The largest absolute difference from the JAX step: losses, every
    parameter and BN running statistic, every momentum buffer."""
    dev = max(abs(a - b) for a, b in zip(ref["losses"], losses))
    want = params_from_flax(ref["state1"])
    got = state.net.state_dict()
    assert set(want) == set(got)
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            dev = max(dev, float((value - got[name]).abs().max()))
    trace = params_from_flax({"params": ref["state1"]["opt_state"][1].trace})
    for name, param in state.net.named_parameters():
        buf = state.optimizer.state[param]["momentum_buffer"]
        dev = max(dev, float((trace[name] - buf).abs().max()))
    return dev


def test_dp_step_matches_the_jax_single_device_step(tmp_path, jax_single_step):
    (losses0, state0), (losses1, state1) = _dp_step(tmp_path, jax_single_step, False)
    assert jax_single_step["batch"]["tid"] != 0  # the step runs a real transform
    assert _max_deviation(jax_single_step, losses0, state0) < F32_ATOL
    # The ranks are bit-equal to each other: losses, weights, BN statistics,
    # momentum buffers, schedule.
    assert losses0 == losses1
    assert ckpt_lib.states_equal(state0, state1)
    assert not np.allclose(state0.net.stem_bn.running_var.numpy(), 1.0)


def test_dp_step_with_local_moments_fails_the_parity_check(tmp_path, jax_single_step):
    """Each rank's BatchNorm on its own 8 rows: the check above tells."""
    (losses0, state0), (losses1, state1) = _dp_step(tmp_path, jax_single_step, True)
    assert _max_deviation(jax_single_step, losses0, state0) > 100 * F32_ATOL
    assert _max_deviation(jax_single_step, losses1, state1) > 100 * F32_ATOL


# ---------------------------------------------------------------------------
# The resignation controller's fence update
# ---------------------------------------------------------------------------

LOGGER = logging.getLogger("test")

# Scripted fence streams: (marked, could-won, games before, games after).
_FENCES = {
    "below_no_resign_games": [(3, 1, 0, 4), (2, 2, 4, 8)],
    "crosses_no_resign_games": [(2, 1, 6, 9), (5, 5, 9, 14), (4, 4, 14, 20)],
    "adjusts_on_high_fp_rate": [(1, 0, 9, 10)] + [(3, 2, 10 + 4 * i, 14 + 4 * i)
                                                 for i in range(8)],
    "no_adjustment_below_target": [(1, 0, 9, 10)] + [(3, 0, 10 + 4 * i, 14 + 4 * i)
                                                    for i in range(8)],
    "periodic_reset": [(4, 3, 10 + 7 * i, 17 + 7 * i) for i in range(12)],
    "reset_window_skipped_in_one_fence": [(2, 2, 10, 12), (9, 9, 12, 95)],
}


@pytest.mark.parametrize("stream", sorted(_FENCES))
@pytest.mark.parametrize("init,no_resign", [(-0.88, 10), (-1.0, 0)])
def test_on_games_global_matches_jax(stream, init, no_resign):
    kw = dict(init_resign_threshold=init, check_resign_after_steps=1, target_fp_rate=0.05,
              disable_resign_ratio=0.1, reset_fp_interval=40, no_resign_games=no_resign)
    ref = JaxResignController(JaxResignConfig(**kw), games_per_ckpt=320, logger=LOGGER)
    ours = pipeline.ResignController(config_lib.ResignConfig(**kw), games_per_ckpt=320,
                                     logger=LOGGER)
    fields = ("threshold", "resign_count", "last_resign_count", "could_won_count")
    for fence in _FENCES[stream]:
        ref.on_games_global(*fence)
        ours.on_games_global(*fence)
        assert [getattr(ref, f) for f in fields] == [getattr(ours, f) for f in fields]
