"""Parity: the port's batched MCTS against the JAX package's.

Both searches run with the same deterministic evaluation functions (a fixed
prior, and a value that counts material — exact in float32 in both
frameworks) and the same Dirichlet draws (the JAX package's, fed to the
port). Visit counts and every integer field of the trees must be equal;
value sums agree to float32 rounding of the backup sums. The search with
reuse across a move also runs at 19x19 (A=362), go19_jumbo's board.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.go import GoEngine as JaxGoEngine
from alpha_zero_tpu.search import mcts as jax_mcts
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.envs.types import GameState
from alpha_zero_tpu_torch.search import mcts

from torch_parity import assert_tree_equal

N, STACK, BATCH, SIMS = 5, 4, 4, 16
A = N * N + 1
# The reuse case also runs at go19_jumbo's board: A=362 actions.
SIZES = [N, 19]
# Value sums are float32 sums of many backups. The noised root priors
# (max(P, 0) * 0.75 + noise * 0.25) differ by one ulp where XLA:CPU contracts
# them into a fused multiply-add and PyTorch rounds twice.
W_TOL = {"node_W": 1e-6, "child_W": 1e-6, "root_Q": 1e-6, "node_P": 1e-6,
         "child_P": 1e-6}


@functools.lru_cache(maxsize=None)
def _prior(n):
    return np.random.RandomState(7).dirichlet(np.ones(n * n + 1)).astype(np.float32)


def _jax_eval(material: bool, n: int = N):
    prior = jnp.asarray(_prior(n))
    a = n * n + 1

    def eval_fn(obs):
        b = obs.shape[0]
        if material:
            own = obs[..., 0].astype(jnp.int32).sum((1, 2))
            opp = obs[..., 1].astype(jnp.int32).sum((1, 2))
            v = (own - opp).astype(jnp.float32) * 0.05
        else:
            v = jnp.zeros((b,), jnp.float32)
        return jnp.broadcast_to(prior, (b, a)), v

    return eval_fn


def _torch_eval(material: bool, n: int = N):
    prior = torch.from_numpy(_prior(n))
    a = n * n + 1

    def eval_fn(obs):
        b = obs.shape[0]
        if material:
            own = obs[..., 0].to(torch.int32).sum((1, 2))
            opp = obs[..., 1].to(torch.int32).sum((1, 2))
            v = (own - opp).float() * 0.05
        else:
            v = torch.zeros((b,))
        return prior.expand(b, a), v

    return eval_fn


@functools.lru_cache(maxsize=None)
def _engines(n=N):
    return JaxGoEngine(board_size=n, num_stack=STACK), GoEngine(board_size=n, num_stack=STACK)


def _roots(seed=0, moves=3, n=N):
    """A batch of positions a few random legal moves into the game."""
    jax_engine, _ = _engines(n)
    states = jax_engine.init_batch(BATCH)
    rng = np.random.RandomState(seed)
    for _ in range(moves):
        legal = np.asarray(states.legal)
        move = [rng.choice(np.flatnonzero(l[:-1])) for l in legal]
        states = jax_engine.step_batch(states, jnp.asarray(move, jnp.int32))
    return states


@functools.lru_cache(maxsize=None)
def _jitted_search(material, root_noise, max_new_sims, n=N):
    jax_engine, _ = _engines(n)
    return jax.jit(functools.partial(
        jax_mcts.batched_search, _jax_eval(material, n), jax_engine,
        num_simulations=SIMS, root_noise=root_noise, max_new_sims=max_new_sims,
        return_trees=True))


def _jax_search(states, rng, material, root_noise, prev=None, max_new_sims=None, n=N):
    return _jitted_search(material, root_noise, max_new_sims, n)(states, rng, prev_trees=prev)


def _dirichlet(rng, n=N):
    """The Dirichlet draws batched_search makes from ``rng``."""
    keys = jax.random.split(rng, BATCH)
    alpha = jnp.full((n * n + 1,), 0.03, jnp.float32)
    return torch.from_numpy(np.array(
        jax.vmap(lambda k: jax.random.dirichlet(k, alpha))(keys)))


def _torch_search(states, rng, material, root_noise, prev=None, max_new_sims=None, n=N):
    _, engine = _engines(n)
    return mcts.batched_search(
        _torch_eval(material, n), engine, GameState.from_numpy(states),
        num_simulations=SIMS, root_noise=root_noise,
        dirichlet_noise=_dirichlet(rng, n) if root_noise else None,
        prev_trees=prev, max_new_sims=max_new_sims, return_trees=True)


@pytest.mark.parametrize("material,root_noise", [(False, False), (False, True),
                                                 (True, True)])
def test_search_matches_jax(material, root_noise):
    states = _roots(seed=int(material))
    rng = jax.random.PRNGKey(5)
    ref, ref_trees = _jax_search(states, rng, material, root_noise)
    out, out_trees = _torch_search(states, rng, material, root_noise)
    assert_tree_equal(ref._asdict(), out._asdict(), W_TOL)
    assert_tree_equal(ref_trees, out_trees, W_TOL)
    assert int(np.asarray(ref.child_N).sum()) == BATCH * (SIMS - 1)


@pytest.mark.parametrize("n", SIZES)
def test_reuse_across_a_move_matches_jax(n):
    """Search, move, re-root, and search again on the carried trees with a
    shortened loop (``max_new_sims``)."""
    jax_engine, engine = _engines(n)
    a = n * n + 1
    states = _roots(seed=3, n=n)
    rng1, rng2 = jax.random.split(jax.random.PRNGKey(9))
    ref1, ref_trees = _jax_search(states, rng1, True, True, n=n)
    out1, out_trees = _torch_search(states, rng1, True, True, n=n)
    assert_tree_equal(ref1._asdict(), out1._asdict(), W_TOL)

    move = jnp.argmax(ref1.child_N, axis=-1).astype(jnp.int32)
    new_states = jax_engine.step_batch(states, move)
    ref_trees = jax_mcts.reroot_trees(ref_trees, move, new_states.done,
                                      new_states, a)
    out_trees = mcts.reroot_trees(out_trees, torch.from_numpy(np.array(move)),
                                  torch.from_numpy(np.array(new_states.done)),
                                  GameState.from_numpy(new_states), a)
    assert_tree_equal(ref_trees, out_trees, W_TOL)

    ref2, ref_trees = _jax_search(new_states, rng2, True, True, ref_trees, 6, n)
    out2, out_trees = _torch_search(new_states, rng2, True, True, out_trees, 6, n)
    assert_tree_equal(ref2._asdict(), out2._asdict(), W_TOL)
    assert_tree_equal(ref_trees, out_trees, W_TOL)
    assert (np.asarray(ref2.child_N).sum(-1) > 6).any()  # visits were carried


def test_reroot_field_by_field():
    """On the same (JAX-grown) trees: a reused subtree, a move without a
    node (fresh tree) and a finished game (fresh tree)."""
    jax_engine, _ = _engines()
    states = _roots(seed=4)
    _, trees = _jax_search(states, jax.random.PRNGKey(2), True, True)
    child_n = np.asarray(jax.vmap(lambda t: jnp.zeros(A).at[
        jnp.where(t.parent_index == 0, t.action_from_parent, A).astype(jnp.int32)
    ].add(t.node_N, mode="drop"))(trees))
    legal = np.asarray(states.legal)
    move = child_n.argmax(-1)
    unvisited = np.flatnonzero((legal[2] > 0) & (child_n[2] == 0))
    move[2] = unvisited[0]
    move = jnp.asarray(move, jnp.int32)
    new_states = jax_engine.step_batch(states, move)
    done = np.asarray(new_states.done).copy()
    done[3] = True
    ref = jax_mcts.reroot_trees(trees, move, jnp.asarray(done), new_states, A)
    out = mcts.reroot_trees(mcts.Tree.from_numpy(trees),
                            torch.from_numpy(np.array(move)),
                            torch.from_numpy(done),
                            GameState.from_numpy(new_states), A)
    assert_tree_equal(ref, out)
    assert float(np.asarray(ref.num_nodes)[0]) > 1
    assert float(np.asarray(ref.num_nodes)[2]) == 1.0


@pytest.mark.parametrize("deterministic", [False, True])
def test_policy_and_move_sampling_with_jax_draws(deterministic):
    rng = np.random.RandomState(11)
    b = 16
    legal = (rng.rand(b, A) < 0.6).astype(np.float32)
    legal[:, -1] = 1.0
    child_n = (rng.randint(0, 30, size=(b, A)) * (rng.rand(b, A) < 0.5)).astype(np.float32)
    child_n[0] = 0.0          # nothing visited: uniform fallback
    child_n[1, :-1] = 0.0     # only pass visited: banned in warm-up
    child_w = (rng.randn(b, A) * child_n * 0.3).astype(np.float32)
    warm_up = rng.rand(b) < 0.5
    warm_up[:2] = True
    key = jax.random.PRNGKey(13)

    ref_pi = jax_mcts.policy_from_counts(jnp.asarray(child_n), jnp.asarray(legal),
                                         jnp.asarray(warm_up))
    out_pi = mcts.policy_from_counts(torch.from_numpy(child_n), torch.from_numpy(legal),
                                     torch.from_numpy(warm_up))
    np.testing.assert_allclose(np.asarray(ref_pi), out_pi.numpy(), rtol=0, atol=1e-6)

    ref_move = jax_mcts.sample_move(key, ref_pi, jnp.asarray(legal), jnp.asarray(child_n),
                                    jnp.asarray(warm_up), A - 1, deterministic)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (b, A), jnp.float32)))
    out_move = mcts.sample_move(gumbel, out_pi, torch.from_numpy(legal),
                                torch.from_numpy(child_n), torch.from_numpy(warm_up),
                                A - 1, deterministic)
    np.testing.assert_array_equal(np.asarray(ref_move), out_move.numpy())

    ref_q = jax_mcts.best_child_q(jnp.asarray(child_n), jnp.asarray(child_w), ref_move)
    out_q = mcts.best_child_q(torch.from_numpy(child_n), torch.from_numpy(child_w), out_move)
    np.testing.assert_array_equal(np.asarray(ref_q), out_q.numpy())


def _grown_go9_trees(batch, sims):
    """The port's trees after one 9x9 search (fixed prior, material value),
    and the JAX package's ``Tree`` holding the same arrays."""
    engine = GoEngine(board_size=9, num_stack=2)
    a = engine.num_actions
    prior = torch.from_numpy(np.random.RandomState(3).dirichlet(np.ones(a)).astype(np.float32))

    def eval_fn(obs):
        own = obs[..., 0].to(torch.int32).sum((1, 2))
        opp = obs[..., 1].to(torch.int32).sum((1, 2))
        return prior.expand(obs.shape[0], a), (own - opp).float() * 0.05

    _, trees = mcts.batched_search(eval_fn, engine, engine.init_batch(batch, device="cpu"),
                                   sims, return_trees=True)
    arrays = trees.to_numpy()
    jax_trees = jax_mcts.Tree(**{k: jnp.asarray(v) for k, v in arrays.items() if k != "states"},
                              states=jax_mcts.NodeState(**{
                                  k: jnp.asarray(v) for k, v in arrays["states"].items()}))
    return trees, jax_trees


def test_tree_writes_match_jax_field_by_field():
    """The port's ``_materialize_scatter`` and ``_expand_backup_scatter``
    (each one tree-row writer call) against the JAX package's on one grown
    go9-shaped tree, every field exact: lanes that write, lanes whose tree
    is full, lanes that hit a terminal node or whose budget is spent."""
    batch, sims = 8, 16
    trees, jax_trees = _grown_go9_trees(batch, sims)
    capacity, a = sims + 1, trees.child_P.shape[-1]
    rng = np.random.RandomState(17)
    slot = np.asarray(jax_trees.num_nodes).astype(np.int32)
    slot[1] = capacity  # a full tree: nothing to write
    used = np.maximum(slot, 1)
    parent = (rng.rand(batch) * used).astype(np.int32)
    action = rng.randint(0, a, size=batch).astype(np.int32)
    child = rng.randint(-1, capacity, size=batch).astype(np.int32)
    hit_terminal = rng.rand(batch) < 0.25
    active = rng.rand(batch) < 0.8
    hit_terminal[0], active[0] = False, True
    node = dict(board=rng.randint(-1, 2, size=(batch, 9, 9)).astype(np.int8),
                labels=rng.randint(-1, 81, size=(batch, 9, 9)).astype(np.int8),
                group_libs=rng.randint(0, 20, size=(batch, 82)).astype(np.int8),
                to_play=rng.choice([-1, 1], size=batch).astype(np.int8),
                pass_streak=rng.randint(0, 2, size=batch).astype(np.int32),
                step_count=rng.randint(0, 90, size=batch).astype(np.int32))
    done = rng.rand(batch) < 0.3
    done[0] = False
    reward = rng.choice([-1.0, 0.0, 1.0], size=batch).astype(np.float32)
    edge_prior = rng.rand(batch).astype(np.float32)

    ref, ref_leaf, ref_eval = jax_mcts._materialize_scatter(
        jax_trees, jnp.asarray(slot), jnp.asarray(parent), jnp.asarray(action),
        jnp.asarray(child), jnp.asarray(hit_terminal), jnp.asarray(active),
        jax_mcts.NodeState(**{k: jnp.asarray(v) for k, v in node.items()}),
        jnp.asarray(done), jnp.asarray(reward), jnp.asarray(edge_prior))
    t = torch.from_numpy
    out, leaf, needs_eval = mcts._materialize_scatter(
        trees, t(slot).long(), t(parent), t(action), t(child), t(hit_terminal),
        t(active), mcts.NodeState(**{k: t(v) for k, v in node.items()}), t(done),
        t(reward), t(edge_prior))
    assert_tree_equal(ref, out)
    np.testing.assert_array_equal(np.asarray(ref_leaf), leaf.numpy())
    np.testing.assert_array_equal(np.asarray(ref_eval), needs_eval.numpy())
    assert 0 < int(np.asarray(ref_eval).sum()) < batch

    even = (rng.rand(batch, capacity) < 0.2).astype(np.float32)
    odd = ((rng.rand(batch, capacity) < 0.2) & (even == 0)).astype(np.float32)
    depth = rng.randint(0, 5, size=batch).astype(np.int32)
    prior = np.where(rng.rand(batch, a) < 0.8, rng.rand(batch, a), -1.0).astype(np.float32)
    value = rng.uniform(-1, 1, size=batch).astype(np.float32)
    ref = jax_mcts._expand_backup_scatter(
        ref, jnp.asarray(slot), ref_leaf, ref_eval, jnp.asarray(active), jnp.asarray(even),
        jnp.asarray(odd), jnp.asarray(depth), jnp.asarray(prior), jnp.asarray(value))
    out = mcts._expand_backup_scatter(out, t(slot).long(), leaf, needs_eval, t(active),
                                      t(even), t(odd), t(depth), t(prior), t(value))
    assert_tree_equal(ref, out)
