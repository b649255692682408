"""Parity: the port's select (the plain version the CUDA kernel is held to)
against the JAX package's ``_select_leaf`` and its Pallas kernel in
interpret mode. The kernel itself is tested on the card by
``tests/test_torch_cuda.py``.

Trees are grown by the JAX package's own search, as
``tests/test_pallas_kernels.py`` grows them, and carried over with
``from_numpy``; or made with numpy from a seed
(``alpha_zero_tpu_torch/tools/select_bench.py:synthetic_trees``), one edge
case of the descent per case. Every output must be equal, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu.envs.go import GoEngine
from alpha_zero_tpu.envs.gomoku import GomokuEngine
from alpha_zero_tpu.models.resnet import AlphaZeroNet
from alpha_zero_tpu.ops import tree_kernels as jax_tree_kernels
from alpha_zero_tpu.search import mcts as jax_mcts
from alpha_zero_tpu_torch.ops import tree_kernels
from alpha_zero_tpu_torch.tools.select_bench import FIELDS, KINDS, synthetic_trees

NAMES = ("parent", "action", "child", "hit_terminal", "even", "odd", "depth", "p_sel")


def _eval_fn(engine, seed=0):
    net = AlphaZeroNet(num_actions=engine.num_actions, num_res_blocks=1,
                       num_filters=8, num_fc_units=8)
    dummy = jnp.zeros((1, engine.board_size, engine.board_size,
                       2 * engine.num_stack + 1), jnp.int8)
    variables = net.init(jax.random.PRNGKey(seed), dummy, train=False)

    def f(obs):
        out = net.apply(variables, obs, train=False)
        return jax.nn.softmax(out.pi_logits, axis=-1), out.value

    return f


def _grown_trees(engine, batch, sims, seed=3):
    """Real post-search trees of lanes that diverged by two random moves."""
    states = engine.init_batch(batch)
    rng = jax.random.PRNGKey(seed)
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        legal = jax.vmap(engine.legal_actions)(states)
        move = jax.random.categorical(sub, jnp.log(legal + 1e-9), axis=-1)
        states = engine.step_batch(states, move.astype(jnp.int32))
    _, trees = jax_mcts.batched_search(
        _eval_fn(engine), engine, states, rng, num_simulations=sims,
        root_noise=True, return_trees=True)
    return trees


_ENGINES = {
    "go5": lambda: GoEngine(board_size=5, num_stack=2),
    "gomoku5": lambda: GomokuEngine(board_size=5, num_stack=2, num_to_win=3),
}


@functools.lru_cache(maxsize=None)
def _case(name, batch=8, sims=16):
    engine = _ENGINES[name]()
    trees = _grown_trees(engine, batch, sims)
    kw = dict(path_cap=min(sims + 1, engine.max_steps + 2),
              c_puct_base=19652.0, c_puct_init=1.25)
    vecs = tuple(torch.from_numpy(np.array(getattr(trees, f))) for f in FIELDS)
    return trees, vecs, kw


def _assert_outputs_equal(ref, out):
    for name, r, o in zip(NAMES, ref, out):
        o = o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        np.testing.assert_array_equal(np.asarray(r), o, err_msg=name)


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_plain_select_matches_jax(name):
    trees, vecs, kw = _case(name)
    ref = jax.vmap(functools.partial(jax_mcts._select_leaf, **kw))(trees)
    out = tree_kernels.select_leaf_plain(*vecs, **kw)
    _assert_outputs_equal(ref, out)
    assert out[0].dtype == torch.int32 and out[3].dtype == torch.bool
    assert int(out[6].max()) >= 2  # the trees are deep enough to matter


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_plain_select_matches_pallas_interpret(name):
    trees, vecs, kw = _case(name)
    ref = jax_tree_kernels.select_leaf_batched(
        *(getattr(trees, f) for f in FIELDS), block=4, interpret=True, **kw)
    _assert_outputs_equal(ref, tree_kernels.select_leaf_plain(*vecs, **kw))


@pytest.mark.parametrize("path_cap", [0, 1, 2])
def test_plain_select_path_cap(path_cap):
    """A descent cut by path_cap stops where the JAX loop stops."""
    trees, vecs, kw = _case("go5")
    kw = dict(kw, path_cap=path_cap)
    ref = jax.vmap(functools.partial(jax_mcts._select_leaf, **kw))(trees)
    _assert_outputs_equal(ref, tree_kernels.select_leaf_plain(*vecs, **kw))


def test_wrapper_runs_plain_version_on_cpu():
    trees, vecs, kw = _case("go5")
    before = tree_kernels.select_leaf_batched.launches
    out = tree_kernels.select_leaf_batched(*vecs, **kw)
    _assert_outputs_equal(tree_kernels.select_leaf_plain(*vecs, **kw), out)
    assert tree_kernels.select_leaf_batched.launches == before


def test_wrapper_rejects_bad_inputs():
    _, vecs, kw = _case("go5")
    with pytest.raises(TypeError):
        tree_kernels.select_leaf_batched(vecs[0].double(), *vecs[1:], **kw)
    with pytest.raises(ValueError):
        tree_kernels.select_leaf_batched(vecs[0][:, :-1], *vecs[1:], **kw)
    with pytest.raises(ValueError):
        tree_kernels.select_leaf_batched(*vecs[:6], vecs[6].transpose(0, 1), **kw)
    with pytest.raises(ValueError):
        tree_kernels.select_leaf_batched(
            vecs[0].t().contiguous().t(), *vecs[1:], **kw)
    with pytest.raises(ValueError):
        tree_kernels.select_leaf_batched(*(v.to("meta") for v in vecs), **kw)


# ---------------------------------------------------------------------------
# Synthetic trees: the descent's edge cases, one kind of lane per case
# ---------------------------------------------------------------------------

_SYNTH_T, _SYNTH_A = 33, 26  # the chains run _SYNTH_T - 4 = 29 deep


def _synthetic(kinds, batch, seed=0):
    arrays = synthetic_trees(batch, _SYNTH_T, _SYNTH_A, seed, kinds)
    return arrays, tuple(torch.from_numpy(arrays[f]) for f in FIELDS)


def _check_case(kinds, arrays, out, path_cap):
    """The case reaches what it is made for."""
    parent, action, child, hit, even, odd, depth, p_sel = out
    if kinds == ("chain",):
        want = min(path_cap, _SYNTH_T - 3)
        assert (depth == want).all()
        assert bool((child >= 0).all()) == (path_cap < _SYNTH_T - 3)
    elif kinds == ("terminal",):
        assert hit.all() and (depth == 3).all()
    elif kinds == ("unexpanded",):
        assert (action == 0).all() and (child == -1).all() and (p_sel == -1.0).all()
    elif kinds == ("ties",):
        assert (depth >= 2).all()
    elif kinds == ("zeros",):
        legal = arrays["child_P"][arrays["child_P"] >= 0]
        assert (legal == 0).all() and np.signbit(legal).any() and not np.signbit(legal).all()
        assert (depth >= 2).any()
    assert ((even + odd).sum(dim=1) == depth.float()).all()


@pytest.mark.parametrize("kinds,batch,block,path_cap", [
    (("random",), 6, 3, _SYNTH_T),
    (("chain",), 6, 2, _SYNTH_T),   # each chain ends in a fresh action
    (("chain",), 6, 3, 5),          # path_cap cuts every chain
    (("ties",), 6, 3, _SYNTH_T),
    (("zeros",), 6, 3, _SYNTH_T),
    (("terminal",), 6, 3, _SYNTH_T),
    (("unexpanded",), 6, 3, _SYNTH_T),
    (KINDS, 7, 7, 12),              # every kind in one batch
], ids=["random", "chain", "chain_cut", "ties", "zeros", "terminal", "unexpanded",
        "mixed_b7"])
def test_synthetic_trees_match_pallas_interpret(kinds, batch, block, path_cap):
    """B is no multiple of 4; the Pallas grid is B // block."""
    arrays, vecs = _synthetic(kinds, batch)
    kw = dict(path_cap=path_cap, c_puct_base=19652.0, c_puct_init=1.25)
    ref = jax_tree_kernels.select_leaf_batched(
        *(jnp.asarray(arrays[f]) for f in FIELDS), block=block, interpret=True, **kw)
    out = tree_kernels.select_leaf_plain(*vecs, **kw)
    _assert_outputs_equal(ref, out)
    _check_case(kinds, arrays, out, path_cap)


@pytest.mark.parametrize("capacity,num_actions", [(_SYNTH_T, _SYNTH_A), (201, 82)])
def test_synthetic_trees_keep_the_search_invariants(capacity, num_actions):
    arrays = synthetic_trees(12, capacity, num_actions, seed=1)
    for b in range(12):
        par = arrays["parent_index"][b].astype(int)
        act = arrays["action_from_parent"][b].astype(int)
        used = par >= 0
        n = 1 + int(used.sum())
        assert used[1:n].all() and not used[n:].any() and par[0] == -1
        slots = np.flatnonzero(used)
        assert (par[used] < slots).all()  # parents sit below their children
        pairs = set(zip(par[used], act[used]))
        assert len(pairs) == len(slots)  # each (parent, action) once
        assert (arrays["child_P"][b][par[used], act[used]] >= 0).all()  # legal
        np.testing.assert_array_equal(arrays["node_P"][b][used],
                                      arrays["child_P"][b][par[used], act[used]])
        assert (act[~used] == -1).all() and (arrays["node_N"][b][n:] == 0).all()
        assert (arrays["child_P"][b][n:] == -1).all()
