"""Engine parity sweep of the PyTorch port: the batched engine on one
NVIDIA GPU against the CPU.

    python3 tools/device_parity_torch.py [--game go|gomoku] [--board-size N]
        [--batches 256 1024 2048 4096] [--steps 12] [--device cuda]

Steps identical random legal games (the moves of ``tools/device_parity.py``
for the same batch size) through ``step_batch`` on ``--device`` and on the
CPU and diffs every analysis field after every step
(``alpha_zero_tpu_torch/tools/device_parity.py:sweep``). Prints
``B=...: OK`` or ``B=...: DIVERGED step j field f (k lanes)`` a batch size
and exits 1 on any divergence. Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alpha_zero_tpu_torch.tools.device_parity import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
