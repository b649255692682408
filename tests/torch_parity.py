"""Helpers shared by the ``test_torch_*`` parity tests: moving state between
the JAX package and the PyTorch port through numpy, and comparing it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs a test module on one torch thread. Its tests drive many small
    ops, whose intra-op threads, several test workers on one host's cores
    at once, otherwise slow each other down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(x):
    """A JAX pytree or a port struct as nested dicts of numpy arrays."""
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def assert_tree_equal(ref, out, atol: dict | None = None, path: str = "") -> None:
    """Field by field: exact, except fields named in ``atol`` (name ->
    absolute tolerance)."""
    ref, out = np_tree(ref), np_tree(out)
    if isinstance(ref, dict):
        assert set(ref) == set(out), (path, sorted(ref), sorted(out))
        for k in ref:
            assert_tree_equal(ref[k], out[k], atol, f"{path}.{k}" if path else k)
        return
    assert ref.shape == out.shape, (path, ref.shape, out.shape)
    tol = (atol or {}).get(path.rsplit(".", 1)[-1])
    if tol is None:
        np.testing.assert_array_equal(ref, out.astype(ref.dtype), err_msg=path)
    else:
        np.testing.assert_allclose(ref, out, rtol=0, atol=tol, err_msg=path)


def flax_variables(net, obs, seed):
    """Initialized variables with randomized BN scale/bias/statistics, so
    every BN term of the conversion shows in the output."""
    import jax
    import jax.numpy as jnp

    variables = net.init(jax.random.PRNGKey(seed), jnp.asarray(obs), train=False)
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        return x

    return {k: jax.tree_util.tree_map_with_path(perturb, variables[k])
            for k in ("params", "batch_stats")}


def jax_transform_id(key) -> int:
    """The transform id the JAX package's ``apply_random_transformation(key,
    ...)`` applies."""
    import jax

    from alpha_zero_tpu.ops import symmetry

    rng_do, rng_pick = jax.random.split(key)
    pick = int(jax.random.randint(rng_pick, (), 0, len(symmetry.REFERENCE_TRANSFORMS)))
    return 0 if bool(jax.random.bernoulli(rng_do, 0.5)) else symmetry.REFERENCE_TRANSFORMS[pick]


def jax_np_state(state) -> dict:
    """A JAX ``TrainState`` as the numpy trees ``train_state_from_flax``
    reads (device arrays, sharded or not, copied to the host)."""
    import jax

    return jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats,
                                     "opt_state": state.opt_state,
                                     "training_steps": state.training_steps})


class JaxGumbels:
    """The move-sampling draws of the JAX package's lockstep games from
    ``PRNGKey(seed)``: at ply p, ``rng, sub = split(rng)``, then
    ``jax.random.categorical(split(sub, 2)[1], logits)``, which is
    ``argmax(gumbel(key, logits.shape) + logits)``. Called with a ply, it
    returns that ply's draw ``f32[num_games, num_actions]`` as a tensor."""

    def __init__(self, seed: int, num_games: int, num_actions: int) -> None:
        import jax

        self._jax = jax
        self._rng = jax.random.PRNGKey(seed)
        self._shape = (num_games, num_actions)
        self._draws = []

    def __call__(self, ply: int):
        jax = self._jax
        while len(self._draws) <= ply:
            self._rng, sub = jax.random.split(self._rng)
            key = jax.random.split(sub, 2)[1]
            self._draws.append(np.array(jax.random.gumbel(key, self._shape)))
        return torch.from_numpy(self._draws[ply])
