"""alpha_zero_tpu_torch — the PyTorch/CUDA port of ``alpha_zero_tpu``.

Mirrors the layout and names of the JAX package module for module, so each
function's counterpart is found under the same path:

- ``envs``     — batched Go and Gomoku engines over tensors with a leading
  batch dim.
- ``models``   — the policy/value ResNet as an ``nn.Module`` (Flax-style
  train-mode BatchNorm), plus a loader for Flax weights.
- ``ops``      — hand-written CUDA kernels (``csrc/``), their build, their
  wrappers and plain PyTorch versions; dihedral augmentation.
- ``search``   — batched MCTS over fixed-capacity array trees, and the
  serial object-tree oracle it is checked against (``search/reference.py``).
- ``training`` — the batched self-play step, the learner, replay,
  checkpoints and the ``Trainer``.
- ``eval``     — Elo, the pro-game dataset, matches and the evaluator.
- ``parallel`` — data- and model-parallel training over
  ``torch.distributed``, and the multi-rank dry run.
- ``cli``      — ``python -m alpha_zero_tpu_torch.cli.{train,play,match,
  analysis,plot}``; ``cli/gui.py``, the Tk board client of ``cli.play
  --gui`` and ``--ai_vs_ai``.

The package imports torch and numpy — never JAX, Flax or the JAX
package; ``cli/plot.py`` and two ``cli/analysis.py`` commands also need
pandas and matplotlib, and ``cli/gui.py`` tkinter. Entry points run on ``device="cuda"`` unless the caller asks for
``"cpu"``.
"""

__version__ = "0.1.0"
