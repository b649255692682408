"""Replay and checkpoints of the port, against the JAX package's.

- Replay: the same seed draws the same sample indices; the ring wraps the
  same way; a snapshot saved by either loads in the other.
- Checkpoints: save -> restore gives back the state bit for bit, and the
  next train step from it is bit-equal to the uninterrupted run's.
- The in-repo orbax checkpoint ``logs/go/9x9/ckpt_20000`` (20,000 steps of
  go9), restored by the JAX package and converted by
  ``train_state_from_flax``: float32 logits and values within 1e-4 of
  Flax's on positions from random games, and one more train step from the
  restored state matching JAX's (parameters and BN statistics within 1e-5,
  momentum buffers within 1e-5, losses within 1e-4). ``tools/ckpt_to_torch.py``
  writes it as a port checkpoint that restores to the same state.
"""

import copy
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training import checkpoint as jax_ckpt
from alpha_zero_tpu.training import learner as jax_learner
from alpha_zero_tpu.training.replay import UniformReplay as JaxReplay
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.training import checkpoint as ckpt_lib
from alpha_zero_tpu_torch.training import learner
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.training.replay import UniformReplay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_20000 = os.path.join(REPO, "logs", "go", "9x9", "ckpt_20000")


def _games(rng, n, count, lengths, shape=(3, 3, 2), actions=9):
    for _ in range(count):
        length = rng.randint(*lengths)
        yield (rng.randint(0, 2, size=(length,) + shape).astype(np.int8),
               rng.dirichlet(np.ones(actions), size=length).astype(np.float32),
               rng.choice([-1.0, 1.0], size=length).astype(np.float32))


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [10, 1000])
def test_replay_matches_jax(capacity):
    """Same games, same seed: identical rings, counters and samples, with
    and without wrap-around."""
    ours = UniformReplay(capacity=capacity, obs_shape=(3, 3, 2), num_actions=9, seed=7)
    ref = JaxReplay(capacity=capacity, obs_shape=(3, 3, 2), num_actions=9, seed=7)
    assert ours.sample(4) is None and ref.sample(4) is None
    rng = np.random.RandomState(0)
    for game in _games(rng, 3, 12, (2, 9)):
        ours.add_game(*game)
        ref.add_game(*game)
        for name in ("states", "pi_probs", "values"):
            np.testing.assert_array_equal(getattr(ref, name), getattr(ours, name))
        assert (ours.size, ours.num_samples_added, ours.num_games_added) == (
            ref.size, ref.num_samples_added, ref.num_games_added)
        a, b = ours.sample(4), ref.sample(4)
        if b is None:
            assert a is None
            continue
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert (ours.num_samples_added > capacity) == (capacity == 10)


def test_replay_ring_wraps_oldest_first():
    rp = UniformReplay(capacity=10, obs_shape=(3, 3, 2), num_actions=9, seed=0)
    pis = np.full((6, 9), 1 / 9, np.float32)
    rp.add_game(np.ones((6, 3, 3, 2), np.int8), pis, np.arange(6, dtype=np.float32))
    rp.add_game(np.ones((6, 3, 3, 2), np.int8), pis, np.arange(6, 12, dtype=np.float32))
    assert rp.size == 10 and rp.num_samples_added == 12
    assert set(rp.values.tolist()) == set(range(2, 12))


def test_replay_snapshots_load_across_packages(tmp_path):
    rng = np.random.RandomState(1)
    ours = UniformReplay(capacity=8, obs_shape=(3, 3, 2), num_actions=9, seed=0)
    ref = JaxReplay(capacity=8, obs_shape=(3, 3, 2), num_actions=9, seed=0)
    for game in _games(rng, 3, 3, (2, 5)):
        ours.add_game(*game)
        ref.add_game(*game)
    ours.save(str(tmp_path / "ours.npz"))
    ref.save(str(tmp_path / "ref.npz"))
    assert sorted(os.listdir(tmp_path)) == ["ours.npz", "ref.npz"]  # no temp file left
    a = UniformReplay(capacity=8, obs_shape=(3, 3, 2), num_actions=9, seed=3)
    b = JaxReplay(capacity=8, obs_shape=(3, 3, 2), num_actions=9, seed=3)
    a.load(str(tmp_path / "ref.npz"))
    b.load(str(tmp_path / "ours.npz"))
    for name in ("states", "pi_probs", "values", "num_games_added", "num_samples_added"):
        np.testing.assert_array_equal(getattr(a, name), getattr(ref, name))
        np.testing.assert_array_equal(getattr(b, name), getattr(ours, name))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _small_state(seed=0):
    cfg = config_lib.go9()
    env = dataclasses.replace(cfg.env, board_size=5, num_stack=2)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8,
                                  num_fc_units=8, inference_dtype="float32")
    train = dataclasses.replace(cfg.train, init_lr=0.1, lr_milestones=(2, 4))
    net = build_network(env, net_cfg, device="cpu", seed=seed, dtype="float32")
    return env, net_cfg, train, learner.create_train_state(net, train)


def _batch(env, seed):
    rng = np.random.RandomState(seed)
    states = (rng.rand(8, 5, 5, env.num_planes) < 0.3).astype(np.int8)
    pi = rng.dirichlet(np.ones(env.num_actions), size=8).astype(np.float32)
    values = rng.choice([-1.0, 1.0], size=8).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (states, pi, values))


def test_checkpoint_resume_is_bit_exact(tmp_path):
    env, net_cfg, train, state = _small_state()
    step = learner.make_train_step("float32")
    for i in range(3):  # past the milestone at 2: the schedule state matters
        step(state, *_batch(env, i), transform_id=i)
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, state.training_steps)
    assert os.path.basename(path) == "training_steps_3"
    assert os.listdir(tmp_path) == ["training_steps_3"]  # the temp file was moved
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == path
    assert ckpt_lib.checkpoint_step(path) == 3

    restored = ckpt_lib.restore_checkpoint(path, _small_state(seed=1)[3])
    assert ckpt_lib.states_equal(state, restored)
    for i in (3, 4):  # the uninterrupted run and the resumed one, side by side
        m1 = step(state, *_batch(env, 10 + i), transform_id=i)
        m2 = step(restored, *_batch(env, 10 + i), transform_id=i)
        assert torch.equal(m1.policy_loss, m2.policy_loss) and m1.learning_rate == m2.learning_rate
    assert ckpt_lib.states_equal(state, restored)
    assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)


def test_latest_checkpoint_ignores_other_files(tmp_path):
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("training_steps_9", "training_steps_10", "training_steps_11.tmp",
                 "replay_state.npz"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith("training_steps_10")


# ---------------------------------------------------------------------------
# The in-repo go9 checkpoint
# ---------------------------------------------------------------------------


def _f32_go9(lib):
    cfg = lib.go9()
    return cfg.env, dataclasses.replace(cfg.network, inference_dtype="float32"), cfg.train


@pytest.fixture(scope="module")
def go9_checkpoint():
    """The JAX TrainState restored from ``logs/go/9x9/ckpt_20000``."""
    env, net_cfg, train = _f32_go9(jax_config)
    net = jax_build_network(env, net_cfg)
    tx, sched = jax_learner.make_optimizer(
        train.init_lr, train.lr_decay, train.lr_milestones,
        momentum=train.sgd_momentum, weight_decay=train.l2_regularization)
    template = jax_learner.create_train_state(net, jax.random.PRNGKey(0),
                                              (9, 9, env.num_planes), tx)
    state = jax_ckpt.restore_checkpoint(CKPT_20000, template)
    return net, tx, sched, state


def _np_tree(state):
    return jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "training_steps": state.training_steps})


def _positions(count, seed):
    """Observations from random go9 games, 0 to 60 moves in."""
    env, _, _ = _f32_go9(config_lib)
    engine = build_engine(env)
    states = engine.init_batch(count, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    stops = torch.randint(0, 61, (count,), generator=gen)
    for i in range(60):
        weights = states.legal.clone()
        weights[:, engine.pass_move] = 0.01
        moves = torch.multinomial(weights, 1, generator=gen)[:, 0].to(torch.int32)
        moves = torch.where(stops > i, moves, engine.pass_move)
        states = engine.step_batch(states, torch.where(states.done, engine.pass_move, moves))
    return engine.observation(states).numpy()


def test_in_repo_checkpoint_converts(go9_checkpoint):
    net, _, _, j_state = go9_checkpoint
    env, net_cfg, train = _f32_go9(config_lib)
    state = ckpt_lib.train_state_from_flax(_np_tree(j_state), env, net_cfg, train,
                                           device="cpu")
    assert state.training_steps == int(j_state.training_steps) == 20000
    assert sum(p.numel() for p in state.net.parameters()) == 2998461
    obs = _positions(24, seed=0)
    ref = net.apply({"params": j_state.params, "batch_stats": j_state.batch_stats},
                    jnp.asarray(obs), train=False)
    state.net.eval()
    with torch.no_grad():
        out = state.net(torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(ref.pi_logits), out.pi_logits.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.value), out.value.numpy(), rtol=0, atol=1e-4)
    assert np.asarray(ref.value).std() > 0.05  # trained weights: values spread


def test_in_repo_checkpoint_trains_one_step_like_jax(go9_checkpoint):
    net, tx, sched, j_state = go9_checkpoint
    env, net_cfg, train = _f32_go9(config_lib)
    state = ckpt_lib.train_state_from_flax(_np_tree(j_state), env, net_cfg, train,
                                           device="cpu")
    obs = _positions(16, seed=1)
    rng = np.random.RandomState(2)
    pi = rng.dirichlet(np.ones(env.num_actions) * 0.3, size=16).astype(np.float32)
    values = rng.choice([-1.0, 1.0], size=16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    rng_do, rng_pick = jax.random.split(key)  # the transform JAX's step draws
    assert not bool(jax.random.bernoulli(rng_do, 0.5))
    tid = 1 + int(jax.random.randint(rng_pick, (), 0, 5))
    j_step = jax_learner.make_train_step(net, tx, sched, argument_data=True)
    j_state = jax.tree.map(jnp.array, j_state)  # the step donates its input
    j_new, j_metrics = j_step(j_state, jnp.asarray(obs), jnp.asarray(pi),
                              jnp.asarray(values), key)
    metrics = learner.make_train_step("float32")(
        state, torch.from_numpy(obs), torch.from_numpy(pi), torch.from_numpy(values), tid)
    assert metrics.learning_rate == pytest.approx(float(j_metrics.learning_rate))
    assert abs(float(j_metrics.policy_loss) - float(metrics.policy_loss)) < 1e-4
    assert abs(float(j_metrics.value_loss) - float(metrics.value_loss)) < 1e-4
    ref = _np_tree(j_new)
    want = params_from_flax(ref)
    got = state.net.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), got[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    trace = params_from_flax({"params": ref["opt_state"][1].trace})
    for name, param in state.net.named_parameters():
        np.testing.assert_allclose(trace[name].numpy(),
                                   state.optimizer.state[param]["momentum_buffer"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert state.training_steps == 20001


def test_ckpt_to_torch_tool_writes_a_restorable_checkpoint(go9_checkpoint, tmp_path):
    """``tools/ckpt_to_torch.py`` on ``ckpt_20000``: a port checkpoint named
    by its step that restores bit-equal to ``train_state_from_flax``."""
    spec = importlib.util.spec_from_file_location(
        "ckpt_to_torch", os.path.join(REPO, "tools", "ckpt_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = tool.main(["--ckpt", CKPT_20000, "--config", "go9", "--out", str(tmp_path)])
    assert path == str(tmp_path / "training_steps_20000")
    env, net_cfg, train = _f32_go9(config_lib)
    restored = ckpt_lib.restore_checkpoint(
        path, learner.create_train_state(
            build_network(env, net_cfg, device="cpu", dtype="float32"), train))
    want = ckpt_lib.train_state_from_flax(_np_tree(go9_checkpoint[3]), env, net_cfg, train,
                                          device="cpu")
    assert ckpt_lib.states_equal(want, restored)


def test_train_state_copy_is_independent():
    """``copy.deepcopy`` of a TrainState (how a caller snapshots one) keeps
    the optimizer tied to its own module's parameters."""
    env, _, _, state = _small_state()
    snap = copy.deepcopy(state)
    learner.make_train_step("float32")(state, *_batch(env, 0))
    assert snap.training_steps == 0
    assert set(map(id, snap.optimizer.param_groups[0]["params"])) == set(
        map(id, snap.net.parameters()))
    assert not torch.equal(snap.net.stem_conv.weight, state.net.stem_conv.weight)
    assert not ckpt_lib.states_equal(snap, state)
    # One differing momentum buffer, or scheduler state, is enough.
    again = copy.deepcopy(state)
    assert ckpt_lib.states_equal(again, state)
    next(iter(again.optimizer.state.values()))["momentum_buffer"].add_(1.0)
    assert not ckpt_lib.states_equal(again, state)
    again = copy.deepcopy(state)
    again.scheduler.step()
    assert not ckpt_lib.states_equal(again, state)
