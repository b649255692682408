"""The root-visit histogram (``alpha_zero_tpu_torch/tools/visits_hist.py``)
against the JAX tool ``tools/visits_hist.py``.

The JAX tool runs unchanged on the CPU on a tiny go config (5x5 Go, a
float32 2-block x 16-filter net, 16 simulations with reuse and
``MAX_NEW_SIMS=8``, 4 games, 2 warm and 3 measured moves) that stands in
for ``get_config``'s. Its net's weights, its initial resign draws and its
per-move keys are recorded; fed those (the weights through
``params_from_flax``, the keys as the step's three draws), ``root_visits``
gives the JAX tool's N_root arrays exactly and ``report`` its printed
lines.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.training import selfplay as jax_selfplay
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network, params_from_flax
from alpha_zero_tpu_torch.tools import visits_hist
from alpha_zero_tpu_torch.training import selfplay

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, WARM, STEPS, SIMS, MAX_NEW_SIMS = 4, 2, 3, 16, 8


def _tiny(lib):
    cfg = lib.go9()
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, board_size=5),
        network=dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                    num_fc_units=16, inference_dtype="float32"),
        search=dataclasses.replace(cfg.search, num_simulations=SIMS))


def _jax_draws(key, num_actions, alpha):
    """The three draws JAX's self-play step makes from ``key``."""
    rng_search, rng_move, rng_resign = jax.random.split(key, 3)
    dirichlet = jax.vmap(lambda k: jax.random.dirichlet(
        k, jnp.full((num_actions,), alpha, jnp.float32)))(jax.random.split(rng_search, BATCH))
    gumbel = jax.random.gumbel(rng_move, (BATCH, num_actions), jnp.float32)
    resign_u = jax.random.uniform(rng_resign, (BATCH,))
    return selfplay.SelfplayNoise(
        *(torch.from_numpy(np.array(x)) for x in (dirichlet, gumbel, resign_u)))


def _run_jax_tool(monkeypatch, capsys):
    """The JAX tool's ``main`` on the tiny config: (printed lines, the
    net's variables, the initial state's key, each move's key, each move's
    root visits)."""
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(
        "jax_visits_hist", os.path.join(REPO, "tools", "visits_hist.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # The tool points JAX's compilation cache at its own directory when
    # imported; the tests' setting stays.
    jax.config.update("jax_compilation_cache_dir", cache[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])

    seen = {"keys": [], "visits": []}
    make_step, init_state = jax_selfplay.make_selfplay_step, jax_selfplay.init_selfplay_state

    def recording_make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(variables, sp, rng, threshold):
            seen["variables"] = variables
            seen["keys"].append(rng)
            sp, out = step(variables, sp, rng, threshold)
            seen["visits"].append(np.asarray(out.root_visits))
            return sp, out
        return recorded

    def recording_init(engine, batch, rng, **kwargs):
        seen["init_key"] = rng
        return init_state(engine, batch, rng, **kwargs)

    monkeypatch.setattr(jax_config, "get_config", lambda name: _tiny(jax_config))
    monkeypatch.setattr(jax_selfplay, "make_selfplay_step", recording_make)
    monkeypatch.setattr(jax_selfplay, "init_selfplay_state", recording_init)
    for name, value in (("B", BATCH), ("WARM", WARM), ("STEPS", STEPS),
                        ("MAX_NEW_SIMS", MAX_NEW_SIMS), ("CONFIG", "go9")):
        monkeypatch.setenv(name, str(value))
    capsys.readouterr()
    tool.main()
    return capsys.readouterr().out.splitlines(), seen


def test_root_visits_and_report_match_the_jax_tool(monkeypatch, capsys):
    lines, seen = _run_jax_tool(monkeypatch, capsys)
    assert len(seen["keys"]) == WARM + STEPS

    cfg = visits_hist.with_reuse(_tiny(config_lib), MAX_NEW_SIMS)
    assert cfg.search.reuse_subtree and cfg.search.max_new_sims == MAX_NEW_SIMS
    num_actions = cfg.env.num_actions
    net = build_network(cfg.env, cfg.network, device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, seen["variables"])))
    v = visits_hist.root_visits(
        cfg, BATCH, WARM, STEPS, device="cpu",
        noise=lambda i: _jax_draws(seen["keys"][i], num_actions, cfg.search.dirichlet_alpha),
        resign_u=torch.from_numpy(np.array(jax.random.uniform(seen["init_key"], (BATCH,)))),
        net=net)
    want = np.concatenate(seen["visits"][WARM:])
    assert v.dtype == want.dtype and v.shape == (BATCH * STEPS,)
    np.testing.assert_array_equal(v, want)
    assert 1 < v.min() and v.max() <= SIMS  # carried visits on top of new ones
    assert visits_hist.report(v, "go9", cfg.search, BATCH, WARM) == lines
    assert lines[0] == (f"config=go9 sims={SIMS} max_new_sims={MAX_NEW_SIMS} "
                        f"batch={BATCH} moves={BATCH * STEPS} (after {WARM} warm steps)")


def test_main_reads_the_jax_tools_environment(monkeypatch, capsys):
    """``main`` on the CPU (``DEVICE=cpu``) with the port's own draws: the
    report's lines, shares summing to 1."""
    monkeypatch.setattr(config_lib, "get_config", lambda name: _tiny(config_lib))
    for name, value in (("B", BATCH), ("WARM", 1), ("STEPS", 2),
                        ("MAX_NEW_SIMS", MAX_NEW_SIMS), ("CONFIG", "go9"),
                        ("DEVICE", "cpu")):
        monkeypatch.setenv(name, str(value))
    visits_hist.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"config=go9 sims={SIMS} max_new_sims={MAX_NEW_SIMS} "
                               f"batch={BATCH} moves={2 * BATCH} (after 1 warm steps)")
    shares = [float(line.split(":")[1].split()[0]) for line in lines[3:]]
    assert [line.split(":")[0].strip() for line in lines[3:]] == visits_hist.LABELS
    assert abs(sum(shares) - 1.0) < 1e-3
