"""The self-play throughput bench (``alpha_zero_tpu_torch/tools/bench.py``)
against ``bench.py``.

``bench.py`` runs unchanged on the CPU on tiny configs that stand in for
``get_config``'s (5x5 Go and 7x7 Gomoku, a float32 2-block x 16-filter net,
16 simulations with reuse and ``BENCH_MAX_NEW_SIMS=8``, 4 games, one warm-up
and 3 timed moves), and with ``BENCH_DP=2`` over two of the 8 virtual CPU
devices of ``tests/conftest.py``. Its net's weights, its initial state's
key and every move's key are recorded; fed those (the weights through
``params_from_flax``, the keys as each move's three draws), the port's
``run`` on the CPU plays ``bench.py``'s moves exactly, with ``search_pi``
within 1e-6, and prints lines of the same count, keys, key order, metric
names and ``partial`` flags. Timings are not compared.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.training import selfplay as jax_selfplay
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.tools import bench
from alpha_zero_tpu_torch.training import selfplay

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIMS = 4, 16
ENV = {"BENCH_BATCH": "4", "BENCH_WARMUP": "1", "BENCH_STEPS": "3",
       "BENCH_MAX_NEW_SIMS": "8"}
KNOBS = ("BENCH_CONFIG", "BENCH_BATCH", "BENCH_SIMS", "BENCH_STEPS", "BENCH_WARMUP",
         "BENCH_REUSE", "BENCH_MAX_NEW_SIMS", "BENCH_DP", "BENCH_DEVICE", "BENCH_FORCE_CPU")
# case -> (game, the config's own simulations, knobs on top of ENV, metric)
CASES = {
    "go": ("go", SIMS, {"BENCH_CONFIG": "go9"}, "selfplay_env_steps_per_s_9x9go_200sims"),
    "gomoku": ("gomoku", SIMS, {"BENCH_CONFIG": "gomoku13"},
               "selfplay_env_steps_per_s_gomoku13_16sims"),
    # bench.py's go9 name says 200 simulations whatever BENCH_SIMS is; with
    # reuse off the loop runs num_simulations - 1 and BENCH_MAX_NEW_SIMS is
    # reported but not used.
    "go9_name_with_sims_16_reuse_off": (
        "go", 24, {"BENCH_CONFIG": "go9", "BENCH_SIMS": "16", "BENCH_REUSE": "0",
                   "BENCH_STEPS": "2"}, "selfplay_env_steps_per_s_9x9go_200sims"),
    "go_dp2": ("go", SIMS, {"BENCH_CONFIG": "go9", "BENCH_DP": "2"},
               "selfplay_env_steps_per_s_go9_16sims_dp2"),
}


def _tiny(lib, game, sims=SIMS):
    cfg = lib.go9() if game == "go" else lib.gomoku13()
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, board_size=5 if game == "go" else 7),
        network=dataclasses.replace(cfg.network, num_res_blocks=2, num_filters=16,
                                    num_fc_units=16, inference_dtype="float32"),
        search=dataclasses.replace(cfg.search, num_simulations=sims))


def _jax_draws(key, batch, num_actions, alpha):
    """The three draws JAX's self-play step makes from ``key``."""
    rng_search, rng_move, rng_resign = jax.random.split(key, 3)
    dirichlet = jax.vmap(lambda k: jax.random.dirichlet(
        k, jnp.full((num_actions,), alpha, jnp.float32)))(jax.random.split(rng_search, batch))
    gumbel = jax.random.gumbel(rng_move, (batch, num_actions), jnp.float32)
    resign_u = jax.random.uniform(rng_resign, (batch,))
    return selfplay.SelfplayNoise(
        *(torch.from_numpy(np.array(x)) for x in (dirichlet, gumbel, resign_u)))


def _set_env(monkeypatch, env):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


def _run_bench_py(monkeypatch, capfd, cfg, env):
    """``bench.py``'s ``main`` on ``cfg`` with ``env``: (its JSON lines,
    its ``#`` lines, what it saw: the net's variables, the initial state's
    key, each move's key and output)."""
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    # bench.py points JAX's compilation cache at its own directory when
    # imported; the tests' setting stays.
    jax.config.update("jax_compilation_cache_dir", cache[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])

    seen = {"keys": [], "outputs": []}
    make_step, init_state = jax_selfplay.make_selfplay_step, jax_selfplay.init_selfplay_state

    def recording_make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(variables, sp, rng, threshold):
            seen["variables"] = jax.tree.map(np.array, variables)
            seen["keys"].append(rng)
            sp, out = step(variables, sp, rng, threshold)
            seen["outputs"].append({k: np.array(getattr(out, k))
                                    for k in ("search_pi", "move", "root_visits")})
            return sp, out
        return recorded

    def recording_init(engine, batch, rng, **kwargs):
        seen["init_key"] = rng
        return init_state(engine, batch, rng, **kwargs)

    monkeypatch.setattr(jax_config, "get_config", lambda name: cfg)
    monkeypatch.setattr(jax_selfplay, "make_selfplay_step", recording_make)
    monkeypatch.setattr(jax_selfplay, "init_selfplay_state", recording_init)
    _set_env(monkeypatch, env)
    capfd.readouterr()
    tool.main()
    captured = capfd.readouterr()
    return ([json.loads(x) for x in captured.out.splitlines()],
            [x for x in captured.err.splitlines() if x.startswith("#")], seen)


def _summary(notes):
    """The closing ``#`` line up to its timings."""
    (line,) = [x for x in notes if x.startswith("# config=")]
    return line.split(" timed=")[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_plays_and_prints_as_bench_py(case, monkeypatch, capfd):
    game, own_sims, knobs, metric = CASES[case]
    env = {**ENV, **knobs}
    jax_lines, jax_notes, seen = _run_bench_py(
        monkeypatch, capfd, _tiny(jax_config, game, own_sims), env)
    steps, warmup = int(env["BENCH_STEPS"]), int(env["BENCH_WARMUP"])
    assert len(seen["keys"]) == warmup + steps

    cfg = _tiny(config_lib, game, own_sims)
    monkeypatch.setattr(config_lib, "get_config", lambda name: cfg)
    outputs = []
    make_step = selfplay.make_selfplay_step

    def recording_make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **k):
            sp, out = step(*a, **k)
            outputs.append(out)  # no copy: a later move must not overwrite it
            return sp, out
        return recorded

    monkeypatch.setattr(selfplay, "make_selfplay_step", recording_make)
    knobs = bench.knobs({**env, "BENCH_DEVICE": "cpu"})
    # Spawned ranks take one intra-op thread each, as the test workers do:
    # several processes' thread pools on one host's cores slow each other.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    alpha, num_actions = cfg.search.dirichlet_alpha, cfg.env.num_actions
    result = bench.run(
        **knobs, params=seen["variables"],
        noise=[_jax_draws(k, BATCH, num_actions, alpha) for k in seen["keys"]],
        resign_u=torch.from_numpy(np.array(jax.random.uniform(seen["init_key"], (BATCH,)))))
    notes = [x for x in capfd.readouterr().err.splitlines() if x.startswith("#")]

    # The lines: count, keys and their order, metric names, partial flags.
    assert [list(x) for x in result.lines] == [list(x) for x in jax_lines]
    assert [x["metric"] for x in result.lines] == [metric] * steps
    assert [x.get("partial") for x in result.lines] == [True] * (steps - 1) + [None]
    assert all(x["value"] > 0 and x["unit"] == "env-steps/s" for x in result.lines)
    assert _summary(notes) == _summary(jax_notes)
    assert (sum(x.startswith("# step ") for x in notes)
            == sum(x.startswith("# step ") for x in jax_notes) == steps - 1)

    # The moves: every move's (one process) or every timed move's (ranks).
    dp = knobs["dp"]
    if dp > 1:
        assert len(result.launches) == dp and not outputs  # played in the ranks
        outputs = result.moves
        want = seen["outputs"][warmup:]
    else:
        assert len(outputs) == warmup + steps
        want = seen["outputs"]
        for got, out in zip(result.moves, outputs[warmup:], strict=True):
            for name in selfplay.StepOutput._fields:
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              getattr(out, name).numpy(), err_msg=name)
    assert len(result.moves) == len(result.legal) == steps
    for i, (out, ref) in enumerate(zip(outputs, want)):
        np.testing.assert_array_equal(out.move.numpy(), ref["move"], err_msg=f"move {i}")
        np.testing.assert_array_equal(out.root_visits.numpy(), ref["root_visits"],
                                      err_msg=f"move {i}")
        np.testing.assert_allclose(out.search_pi.numpy(), ref["search_pi"], rtol=0,
                                   atol=1e-6, err_msg=f"move {i}")
    for out, legal in zip(result.moves, result.legal):
        assert legal.shape == (BATCH, num_actions)
        assert bool(legal.gather(1, out.move.long()[:, None]).all())
    # The wrappers count only kernel launches; the CPU launches none.
    assert result.launches == [[(0, 0)] * steps] * max(dp, 1)
    assert result.peak_bytes == [None] * max(dp, 1)


def test_batch_not_divisible_by_dp_exits_as_bench_py(monkeypatch, capfd):
    env = {**ENV, "BENCH_CONFIG": "go9", "BENCH_BATCH": "5", "BENCH_DP": "2"}
    with pytest.raises(SystemExit) as jax_exit:
        _run_bench_py(monkeypatch, capfd, _tiny(jax_config, "go"), env)
    monkeypatch.setattr(config_lib, "get_config", lambda name: _tiny(config_lib, "go"))
    with pytest.raises(SystemExit) as port_exit:
        bench.run(**bench.knobs({**env, "BENCH_DEVICE": "cpu"}))
    assert str(port_exit.value) == str(jax_exit.value) == (
        "BENCH_BATCH=5 not divisible by BENCH_DP=2")


def test_main_reads_bench_py_environment(monkeypatch, capfd):
    """``main`` on the CPU (``BENCH_DEVICE=cpu``) with the port's own draws:
    the knobs as ``bench.py`` reads them, the lines on stdout, the notes on
    stderr."""
    monkeypatch.setattr(config_lib, "get_config", lambda name: _tiny(config_lib, "gomoku"))
    _set_env(monkeypatch, {**ENV, "BENCH_CONFIG": "gomoku13", "BENCH_STEPS": "2",
                           "BENCH_DEVICE": "cpu"})
    result = bench.main()
    captured = capfd.readouterr()
    lines = [json.loads(x) for x in captured.out.splitlines()]
    assert lines == result.lines and len(lines) == 2
    assert lines[0]["partial"] and "partial" not in lines[1]
    assert lines[1]["metric"] == "selfplay_env_steps_per_s_gomoku13_16sims"
    notes = captured.err.splitlines()
    assert "# config=gomoku13 batch=4 sims=16 reuse=True max_new_sims=8 dp=1 timed=" in (
        "\n".join(notes))
    (launches,) = [x for x in notes if x.startswith(bench.LAUNCHES_PREFIX)]
    assert json.loads(launches[len(bench.LAUNCHES_PREFIX):]) == [[[0, 0], [0, 0]]]
    assert result.last.search_pi.shape == (BATCH, 49)
    torch.testing.assert_close(result.last.search_pi.sum(-1), torch.ones(BATCH))
    assert bool((result.last.root_visits <= SIMS).all())



def test_knobs_resolve_as_bench_py():
    """The defaults and knobs of ``bench.py`` on the real configs: batch,
    simulations, the loop's length, the search config and the metric."""
    assert bench.knobs({}) == dict(config_name="go9", batch=None, sims=None, steps=8,
                                   warmup=1, reuse=None, max_new_sims=None, dp=0,
                                   device="cuda")
    cases = [
        ((), (1024, 200, True, 120, 120, "selfplay_env_steps_per_s_9x9go_200sims")),
        (("gomoku13",), (1024, 380, True, 240, 240,
                         "selfplay_env_steps_per_s_gomoku13_380sims")),
        (("go19_jumbo", 256), (256, 800, True, 480, 480,
                               "selfplay_env_steps_per_s_go19_jumbo_800sims")),
        (("go9", None, 64, 8, 1, False, 50), (1024, 64, False, 50, 63,
                                              "selfplay_env_steps_per_s_9x9go_200sims")),
        (("go9", 256, None, 2, 1, None, None, 2),
         (256, 200, True, 120, 120, "selfplay_env_steps_per_s_go9_200sims_dp2")),
    ]
    for args, (batch, sims, reuse, max_new_sims, loop_len, metric) in cases:
        b = bench.resolve(*args)
        assert (b.batch, b.sims, b.reuse, b.max_new_sims, b.loop_len, b.metric) == (
            batch, sims, reuse, max_new_sims, loop_len, metric), args
        assert b.search.num_simulations == sims and b.search.reuse_subtree == reuse
        assert b.search.max_new_sims == (max_new_sims if reuse else None)
    with pytest.raises(ValueError, match="timed move"):
        bench.resolve("go9", steps=0)
