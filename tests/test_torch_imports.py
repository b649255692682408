"""Import hygiene of the PyTorch port: it never reaches JAX or the JAX
package, its kernel layer imports nothing above it, and its entry points
do not drop silently to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "alpha_zero_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "alpha_zero_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tools" / "profile_torch_selfplay.py",
                                         REPO / "tools" / "dma_probe_torch.py",
                                         REPO / "tools" / "select_bench_torch.py"]


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def _imports(path):
    """``(line, module)`` of every import in ``path``, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or ""


# The evaluator path's modules, each a copy or port of its JAX namesake.
EVAL_PATH = ("eval/__init__.py", "eval/elo.py", "eval/dataset.py", "eval/match.py",
             "eval/evaluator.py", "envs/host.py", "cli/play.py", "cli/match.py")
# The data- and model-parallel path's modules.
PARALLEL_PATH = ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                 "parallel/dryrun.py")


def test_port_sources_import_nothing_of_jax():
    offenders = [f"{path.relative_to(REPO)}:{line} {name}"
                 for path in _port_files() for line, name in _imports(path)
                 if name.split(".")[0] in BANNED]
    assert not offenders, offenders
    assert len(_port_files()) > 10
    assert {PORT / p for p in EVAL_PATH + PARALLEL_PATH} <= set(_port_files())


def test_kernel_layer_imports_nothing_above_it():
    """``ops/`` (the kernels, their wrappers and plain versions) sits below
    the search, the training loop and the measuring tools."""
    above = tuple(f"alpha_zero_tpu_torch.{m}" for m in ("search", "training", "tools"))
    files = sorted((PORT / "ops").glob("*.py"))
    offenders = [f"{path.relative_to(REPO)}:{line} {name}"
                 for path in files for line, name in _imports(path)
                 if name.startswith(above)]
    assert not offenders, offenders
    assert len(files) >= 3


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.cli import train as cli_train
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.parallel import mesh
    from alpha_zero_tpu_torch.training import pipeline, selfplay
    from alpha_zero_tpu_torch.training.checkpoint import train_state_from_flax
    from alpha_zero_tpu_torch.training.pipeline import build_engine

    cfg = config_lib.go9()
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign)
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.init_selfplay_state(engine, 2, None, -1.0, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_network(cfg.env, cfg.network)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.init_batch(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(config_lib.gomoku13().env).init_batch(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--config", "go9", "--no-eval"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_state_from_flax({}, cfg.env, cfg.network, cfg.train)
    # A data-parallel launch checks the device before it starts a rank.
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--config", "go9", "--no-eval", "--set", "parallel.dp=2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.rank_device("cuda", 0, 1)


def test_evaluator_path_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.cli import match as cli_match
    from alpha_zero_tpu_torch.cli import play as cli_play
    from alpha_zero_tpu_torch.envs.host import GoEnv, GomokuEnv
    from alpha_zero_tpu_torch.eval import dataset, evaluator, match
    from alpha_zero_tpu_torch.models.resnet import build_network
    from alpha_zero_tpu_torch.training.pipeline import build_engine

    cfg = config_lib.go9()
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device="cpu")
    (tmp_path / "a.sgf").write_text("(;SZ[9]KM[7.5]RE[B+1.5];B[cc])")
    calls = [
        lambda: GoEnv(), lambda: GomokuEnv(),
        lambda: dataset.build_eval_dataset(str(tmp_path), 9, 8),
        lambda: dataset.build_eval_dataset(str(tmp_path), 9, 8, fast=False),
        lambda: match.play_matches(engine, cfg.search, net, net, 2),
        lambda: match.play_matches_asym(engine, cfg.search, cfg.search, net, net, 2),
        lambda: evaluator.Evaluator(engine, net, cfg.search),
        lambda: evaluator.play_eval_game(engine, None, net, net),
        lambda: evaluator.eval_on_pro_games(net, dataset.build_eval_dataset(
            str(tmp_path), 9, 8, device="cpu")),
        lambda: cli_play.load_variables(cfg, ""),
        lambda: cli_match.main(["--black_ckpt", "", "--white_ckpt", ""]),
        lambda: cli_play.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
