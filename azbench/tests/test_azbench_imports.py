"""What a run loads: no JAX and no JAX package, compared by whole
top-level module name, so the port's own name passes."""

import subprocess
import sys

from azbench import harness


def test_forbidden_names_are_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("alpha_zero_tpu", None)
        sys.modules["alpha_zero_tpu_torch_fake"] = sys
        assert "alpha_zero_tpu_torch_fake" not in harness.forbidden_modules()
        sys.modules["alpha_zero_tpu.envs"] = sys
        assert harness.forbidden_modules() == ["alpha_zero_tpu.envs"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """Everything run.py loads for a cell, and the reference, in a fresh
    interpreter."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from azbench import harness, arith, trace;"
        "import azbench.reference.go, azbench.reference.nets.resnet, azbench.reference.mcts;"
        "harness.load_module(harness.HERE / 'entries' / 'selfplay.py');"
        "[harness.load_module(p) for p in sorted((harness.HERE / 'metrics').glob('*.py'))];"
        "bad = harness.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        text = path.read_text()
        assert "alpha_zero_tpu" not in text.replace("alpha_zero_tpu_torch", ""), path
        assert "import alpha_zero_tpu_torch" not in text and "from alpha_zero_tpu_torch" not in text


def test_run_needs_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    done = subprocess.run([sys.executable, "azbench/run.py", "--workload", "go9.selfplay",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    import torch

    if torch.cuda.is_available():
        return
    assert done.returncode != 0 and done.stdout.strip() == ""
