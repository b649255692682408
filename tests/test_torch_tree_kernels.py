"""Parity: the port's select (the plain version the CUDA kernel is held to)
against the JAX package's ``_select_leaf`` and its Pallas kernel in
interpret mode. The kernel itself is tested on the card by
``tests/test_torch_cuda.py``.

Trees are grown by the JAX package's own search, as
``tests/test_pallas_kernels.py`` grows them, and carried over with
``from_numpy``. Every output must be equal, bit for bit.
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
from alpha_zero_tpu_torch.search import mcts

NAMES = ("parent", "action", "child", "hit_terminal", "even", "odd", "depth", "p_sel")
FIELDS = ("node_N", "node_W", "node_P", "parent_index", "action_from_parent",
          "node_done", "child_P")


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
    out = mcts._select_leaf(*vecs, **kw)
    _assert_outputs_equal(ref, out)
    assert out[0].dtype == torch.int32 and out[3].dtype == torch.bool
    assert int(out[6].max()) >= 2  # the trees are deep enough to matter


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_plain_select_matches_pallas_interpret(name):
    trees, vecs, kw = _case(name)
    ref = jax_tree_kernels.select_leaf_batched(
        *(getattr(trees, f) for f in FIELDS), block=4, interpret=True, **kw)
    _assert_outputs_equal(ref, mcts._select_leaf(*vecs, **kw))


@pytest.mark.parametrize("path_cap", [0, 1, 2])
def test_plain_select_path_cap(path_cap):
    """A descent cut by path_cap stops where the JAX loop stops."""
    trees, vecs, kw = _case("go5")
    kw = dict(kw, path_cap=path_cap)
    ref = jax.vmap(functools.partial(jax_mcts._select_leaf, **kw))(trees)
    _assert_outputs_equal(ref, mcts._select_leaf(*vecs, **kw))


def test_wrapper_runs_plain_version_on_cpu():
    trees, vecs, kw = _case("go5")
    before = tree_kernels.select_leaf_batched.launches
    out = tree_kernels.select_leaf_batched(*vecs, **kw)
    _assert_outputs_equal(mcts._select_leaf(*vecs, **kw), out)
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
