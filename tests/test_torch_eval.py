"""Parity of the port's evaluator (``eval/elo.py``, ``eval/evaluator.py``)
with the JAX package's.

- Elo: the same rating sequences over fixed results, in every K band.
- The ``eval_games=1`` game: 5x5 Go, float32 2 x 16 nets of two seeds (the
  port loads the Flax weights), 16 simulations: the same moves and result.
- ``eval_games=4``: the batched evaluator fed the JAX package's sampling
  draws gives the same Elo, win counts and CSV row over two checkpoints.
- Pro metrics on the dataset built from the in-repo go9 games: top-k hit
  counts equal, entropy and value MSE to rtol 1e-5; top-k ties go to the
  lower action, as ``jax.lax.top_k`` sends them, on planted ties.
"""

import dataclasses
import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.eval import elo as jax_elo
from alpha_zero_tpu.eval import evaluator as jax_evaluator
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.training.pipeline import build_engine as jax_build_engine
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.eval import elo, evaluator
from alpha_zero_tpu_torch.eval.dataset import EvalDataset, build_eval_dataset
from alpha_zero_tpu_torch.models.resnet import NetworkOutputs, build_network, params_from_flax
from alpha_zero_tpu_torch.training.pipeline import build_engine

from torch_parity import JaxGumbels, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Elo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [0.0, 2050.0, 2150.0, 2390.0, 2600.0])
def test_elo_sequences_equal_jax(start):
    """Ten games between two players from ``start`` (the K bands and their
    mixed cases as the ratings cross 2100 and 2400), winner first."""
    results = [1, 1, 0, 1, 0.5, 1, 1, 0, 1, 1]
    pairs = [(jax_elo.EloRating(start), jax_elo.EloRating(start + 60)),
             (elo.EloRating(start), elo.EloRating(start + 60))]
    for score in results:
        for a, b in pairs:
            a.update_rating(b.rating, score)
            b.update_rating(a.rating, 1 - score)
        (ja, jb), (ta, tb) = pairs
        assert (ja.rating, jb.rating) == (ta.rating, tb.rating)
    for ratings in ((start, start + 60), (2099, 2100), (2399, 2400), (2000, 2500)):
        assert jax_elo.get_k_factor(ratings) == elo.get_k_factor(ratings)


# ---------------------------------------------------------------------------
# Evaluator games
# ---------------------------------------------------------------------------


def _configs(lib):
    env = lib.EnvConfig(game="go", board_size=5, num_stack=2, max_steps=16)
    net = lib.NetworkConfig(num_res_blocks=2, num_filters=16, num_fc_units=16,
                            inference_dtype="float32")
    return env, net, lib.SearchConfig(num_simulations=16)


@pytest.fixture(scope="module")
def setup():
    env, net_cfg, search = _configs(jax_config)
    flax_net = jax_build_network(env, net_cfg)
    obs = jnp.zeros((1, 5, 5, env.num_planes), jnp.int8)
    variables = []
    for seed in (3, 4):
        v = flax_net.init(jax.random.PRNGKey(seed), obs, train=False)
        variables.append({"params": v["params"], "batch_stats": v["batch_stats"]})
    env_t, net_cfg_t, search_t = _configs(config_lib)
    weights = [params_from_flax(jax.tree.map(np.asarray, v)) for v in variables]
    nets = []
    for w in weights:
        net = build_network(env_t, net_cfg_t, device="cpu")
        net.load_state_dict(w)
        nets.append(net)
    return dict(jax=(jax_build_engine(env), flax_net, search, variables),
                port=(build_engine(env_t), net_cfg_t, search_t, weights, nets))


def test_eval_game_move_for_move_like_jax(setup):
    j_engine, flax_net, j_search, (vb, vw) = setup["jax"]
    engine, _, search, _, (black, white) = setup["port"]
    ref = jax_evaluator.eval_against_prev_ckpt(
        j_engine, jax_evaluator.make_eval_move_fn(j_engine, flax_net, j_search), vb, vw,
        jax_elo.EloRating(), jax_elo.EloRating())
    out = evaluator.eval_against_prev_ckpt(
        engine, evaluator.make_eval_move_fn(engine, search), black, white,
        elo.EloRating(), elo.EloRating(), device="cpu")
    assert [tuple(m) for m in ref.pop("_moves")] == [tuple(m) for m in out.pop("_moves")]
    assert ref == out
    assert out["game_length"] > 4


def test_batched_evaluator_like_jax(setup):
    """Two checkpoints, four games each: the first against itself, the
    second against the promoted first; the stats (the CSV row) equal."""
    j_engine, flax_net, j_search, variables = setup["jax"]
    engine, net_cfg, search, weights, _ = setup["port"]
    ref_ev = jax_evaluator.Evaluator(j_engine, flax_net, j_search, eval_games=4)
    draws = {}

    def jax_draws(seed, ply, n):
        if (seed, n) not in draws:
            draws[seed, n] = JaxGumbels(seed, n, engine.num_actions)
        return draws[seed, n](ply)

    template = build_network(_configs(config_lib)[0], net_cfg, device="cpu")
    ev = evaluator.Evaluator(engine, template, search, eval_games=4, device="cpu",
                             draws=jax_draws)
    for v, w, seed in zip(variables, weights, (3, 7)):
        ref = ref_ev.evaluate(v, seed=seed)
        out = ev.evaluate(w, seed=seed)
        assert [tuple(m) for m in ref.pop("_moves")] == [tuple(m) for m in out.pop("_moves")]
        assert ref == out
        assert ref_ev.black_elo.rating == ev.black_elo.rating
        assert ref_ev.white_elo.rating == ev.white_elo.rating
    assert out["eval_games"] == 4


# ---------------------------------------------------------------------------
# Pro metrics
# ---------------------------------------------------------------------------


def test_pro_metrics_on_in_repo_dataset_like_jax():
    """A float32 go9-shaped 2 x 16 net over the 10k positions of the in-repo
    games: streamed from the host and resident on the device (full batches,
    then the tail), both equal to the JAX package's."""
    ds = build_eval_dataset(os.path.join(REPO, "logs", "go", "9x9_matched", "sgf"), 9, 8,
                            device="cpu")
    cfg = jax_config.go9()
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                  num_fc_units=16, inference_dtype="float32")
    flax_net = jax_build_network(cfg.env, net_cfg)
    variables = flax_net.init(jax.random.PRNGKey(2), jnp.zeros((1, 9, 9, 17), jnp.int8),
                              train=False)
    ref = jax_evaluator.eval_on_pro_games(jax_evaluator.make_pro_metrics_fn(flax_net),
                                          variables, ds, batch_size=1024)
    port_cfg = config_lib.go9()
    net = build_network(port_cfg.env, dataclasses.replace(
        port_cfg.network, num_res_blocks=2, num_filters=16, num_fc_units=16,
        inference_dtype="float32"), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    streamed = evaluator.eval_on_pro_games(net, ds, batch_size=1024, device="cpu")
    ev = evaluator.Evaluator(build_engine(port_cfg.env), net, port_cfg.search,
                             dataset=ds, device="cpu")
    ev.latest_net.load_state_dict(net.state_dict())
    resident = ev._pro_metrics()
    assert len(ds) % 1024  # a tail batch
    for out in (streamed, resident):
        assert set(out) == set(ref)
        for k in (1, 3, 5):
            key = f"policy_top_{k}_accuracy"
            assert out[key] == ref[key], key
        for key in ("policy_entropy", "value_mse_error"):
            assert out[key] == pytest.approx(ref[key], rel=1e-5), key
    assert 0 < ref["policy_top_1_accuracy"] < ref["policy_top_5_accuracy"] < 1


_Out = namedtuple("_Out", ["pi_logits", "value"])


class _FlaxStub:
    """A 'net' whose logits and values are its variables."""

    def apply(self, variables, states, train):
        return _Out(variables["logits"], variables["value"])


def _planted_ties(rows=64, actions=12, seed=0):
    """Logits with many exact ties: a few levels, bf16-rounded, whole rows
    equal; targets often among the tied actions."""
    rng = np.random.RandomState(seed)
    logits = rng.choice([0.0, 0.5, 1.0, 1.0078125], size=(rows, actions)).astype(np.float32)
    logits[:4] = 0.25  # all equal
    target = np.where(rng.rand(rows) < 0.5, rng.randint(0, actions, rows),
                      logits.argmax(-1) + rng.randint(0, 3, rows)) % actions
    return logits, np.eye(actions, dtype=np.float32)[target], rng.uniform(-1, 1, rows).astype(
        np.float32)


def test_topk_ties_break_toward_the_lower_action_like_jax():
    logits, target_pi, target_v = _planted_ties()
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, ref_idx = jax.lax.top_k(probs, 5)
    idx = evaluator.topk_lower_index_first(torch.softmax(torch.from_numpy(logits), -1), 5)
    np.testing.assert_array_equal(np.asarray(ref_idx), idx.numpy())

    ref = jax_evaluator.make_pro_metrics_fn(_FlaxStub())(
        {"logits": jnp.asarray(logits), "value": jnp.asarray(target_v * 0.5)},
        jnp.zeros((len(logits), 1)), jnp.asarray(target_pi), jnp.asarray(target_v))

    def stub(states):
        return NetworkOutputs(torch.from_numpy(logits), torch.from_numpy(target_v * 0.5))

    correct, entropy, mse = evaluator.pro_metrics(
        stub, torch.zeros(len(logits), 1), torch.from_numpy(target_pi),
        torch.from_numpy(target_v))
    for k in (1, 3, 5):
        assert int(correct[k]) == int(ref[0][k]), k
    assert float(entropy) == pytest.approx(float(ref[1]), rel=1e-5)
    assert float(mse) == pytest.approx(float(ref[2]), rel=1e-5)
    assert 0 < int(correct[1]) < int(correct[5]) < len(logits)


def test_empty_dataset_has_no_metrics():
    empty = EvalDataset(states=np.zeros((0, 5, 5, 5), np.int8),
                        target_pi=np.zeros((0, 26), np.float32),
                        target_v=np.zeros((0,), np.float32))
    assert evaluator.eval_on_pro_games(None, empty, device="cpu") == {}
