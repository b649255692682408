"""Helpers shared by the ``test_torch_*`` parity tests: moving state between
the JAX package and the PyTorch port through numpy, and comparing it."""

from __future__ import annotations

import dataclasses

import numpy as np


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
