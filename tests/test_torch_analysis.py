"""Parity of the port's ``cli/analysis.py`` and ``models/resnet.py:count_params``
with the JAX package's.

- ``count_params`` of every config's net equal to JAX's ``count_params``
  over the Flax parameters (shapes from ``jax.eval_shape``, so nothing
  compiles the 19 x 256 net), and ``params --device cpu`` printing them in
  the JAX command's format; the configs the JAX package lacks (the nbt
  net's) with the count of the benchmark reference's layout
  (``azbench/reference/nets/nbt.py``).
- ``puct``, ``score-demo``, ``aggregate-matches``, ``aggregate-actors`` and
  ``filter-sgf``: the same stdout (and the same areas, aggregated CSV and
  copied files) as the JAX command on the same inputs.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alpha_zero_tpu import config as jax_config
from alpha_zero_tpu.cli import analysis as jax_analysis
from alpha_zero_tpu.envs.go import GoEngine as JaxGoEngine
from alpha_zero_tpu.models.resnet import build_network as jax_build_network
from alpha_zero_tpu.models.resnet import count_params as jax_count_params
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.cli import analysis
from alpha_zero_tpu_torch.models.resnet import build_network, count_params
from azbench.reference.nets import nbt as nbt_ref

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_count(name):
    cfg = jax_config.get_config(name)
    net = jax_build_network(cfg.env, cfg.network)
    n = cfg.env.board_size
    obs = jax.ShapeDtypeStruct((1, n, n, cfg.env.num_planes), jnp.int8)
    shapes = jax.eval_shape(lambda o: net.init(jax.random.PRNGKey(0), o, train=False), obs)
    return jax_count_params(shapes["params"])


def _nbt_count(name):
    """Parameters of the nbt net of the port's config ``name``: the kernels,
    dense biases and norm scales and shifts of ``nbt_ref.layout``."""
    cfg = config_lib.get_config(name)
    kernels, norms = nbt_ref.layout({**dataclasses.asdict(cfg.env),
                                     **dataclasses.asdict(cfg.network)})
    dense = sum(s[0] for k, s in kernels if len(s) == 2)
    return sum(int(np.prod(s)) for _, s in kernels) + dense + sum(2 * c for _, c in norms)


@pytest.mark.parametrize("name", sorted(set(config_lib.CONFIGS) & set(jax_config.CONFIGS)))
def test_count_params_like_jax(name):
    cfg = config_lib.get_config(name)
    net = build_network(cfg.env, cfg.network, device="cpu")
    assert count_params(net) == _jax_count(name)
    # BatchNorm's running statistics are buffers, not parameters.
    assert count_params(net) < sum(x.numel() for x in net.state_dict().values())


def test_params_command_prints_the_jax_counts(capsys):
    analysis.main(["params", "--device", "cpu"])
    want = []
    for name in sorted(config_lib.CONFIGS):
        cfg = config_lib.get_config(name)
        n = cfg.env.board_size
        count = _jax_count(name) if name in jax_config.CONFIGS else _nbt_count(name)
        want.append(f"{name:12s} board={n:2d} blocks={cfg.network.num_res_blocks:2d} "
                    f"filters={cfg.network.num_filters:3d} params={count:,}")
    assert capsys.readouterr().out.splitlines() == want


def _outputs(capsys, argv, port_argv=()):
    """stdout of the JAX command and of the port's on ``argv`` (the port's
    with ``port_argv`` added)."""
    jax_analysis.main(list(argv))
    ref = capsys.readouterr().out
    analysis.main(list(argv) + list(port_argv))
    return ref, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["puct"], ["puct", "--c_puct_base", "500", "--c_puct_init", "2.5"],
])
def test_puct_like_jax(capsys, argv):
    ref, out = _outputs(capsys, argv)
    assert out == ref
    assert len(out.splitlines()) == 9


def test_score_demo_like_jax(capsys):
    ref, out = _outputs(capsys, ["score-demo"], ["--device", "cpu"])
    assert out == ref
    assert out.count("computed - black:") == 7
    blacks, whites = analysis.score_demo_areas("cpu")
    boards = np.stack([
        np.array([[{"X": 1, "O": -1, ".": 0}[ch] for ch in row] for row in rows], np.int8)
        for *_, rows in jax_analysis._SCORE_DEMO_GAMES])
    engine = JaxGoEngine(board_size=9, num_stack=2)
    ref_b, ref_w = jax.vmap(engine.area_counts)(jnp.asarray(boards))
    np.testing.assert_array_equal(np.asarray(ref_b), blacks.numpy())
    np.testing.assert_array_equal(np.asarray(ref_w), whites.numpy())


def _match_log(path):
    """A small match log: three players, wins both ways, a draw and a
    resignation."""
    rows = [("a", "b", "B+3.5"), ("b", "a", "W+R"), ("a", "c", "W+0.5"),
            ("c", "b", "DRAW"), ("b", "c", "B+12.5"), ("c", "a", "B+R"),
            ("a", "b", "W+1.5"), ("b", "a", "B+7.5")]
    with open(path, "w") as f:
        f.write("datetime,black,white,game,game_result,game_length\n")
        for i, (b, w, r) in enumerate(rows):
            f.write(f"2026-01-01 00:00:00,{b},{w},{i},{r},{40 + i}\n")
    return str(path)


@pytest.mark.parametrize("log", ["small", "logs/matches_r3/g9_10k_vs_2k_A/log.csv"])
@pytest.mark.parametrize("rating", ["0", "2050"])
def test_aggregate_matches_like_jax(capsys, tmp_path, log, rating):
    path = _match_log(tmp_path / "log.csv") if log == "small" else os.path.join(REPO, log)
    ref, out = _outputs(capsys, ["aggregate-matches", "--log_csv", path,
                                 "--default_rating", rating])
    assert out == ref
    assert len(out.splitlines()) >= 2


def test_aggregate_actors_like_jax(capsys, tmp_path):
    """On a copy of ``logs/go/9x9`` (the command writes its CSV there)."""
    logs = tmp_path / "logs"
    logs.mkdir()
    shutil.copy(os.path.join(REPO, "logs", "go", "9x9", "actor0.csv"), logs)
    argv = ["aggregate-actors", "--logs_dir", str(logs)]
    jax_analysis.main(argv)
    ref, ref_csv = capsys.readouterr().out, (logs / "actors_aggregated.csv").read_text()
    (logs / "actors_aggregated.csv").unlink()
    analysis.main(argv)
    assert capsys.readouterr().out == ref
    assert (logs / "actors_aggregated.csv").read_text() == ref_csv
    assert "games ->" in ref and "black wins:" in ref


def test_filter_sgf_like_jax(capsys, tmp_path):
    games = os.path.join(REPO, "logs", "go", "9x9_matched", "sgf")
    copied = {}
    for label, run in (("jax", jax_analysis.main), ("port", analysis.main)):
        out_dir = tmp_path / label
        argv = ["filter-sgf", "--games_dir", games, "--out_dir", str(out_dir)]
        run(argv + (["--device", "cpu"] if label == "port" else []))
        text = capsys.readouterr().out
        copied[label] = (text.replace(str(out_dir), "OUT"), sorted(os.listdir(out_dir)))
    assert copied["port"] == copied["jax"]
    text, names = copied["port"]
    kept, skipped = (int(x.split()[-1]) for x in text.split(" -> ")[0].split(", "))
    assert kept == len(names) > 0 and skipped > 0
