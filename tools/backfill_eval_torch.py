"""Offline re-evaluation of every saved checkpoint of a PyTorch port run,
on one NVIDIA GPU.

    python3 tools/backfill_eval_torch.py --config go9 --ckpt-dir RUN/ckpt \
        --eval-games-dir logs/go/9x9_matched/sgf --out RUN/evaluation_backfill.csv \
        [--eval-games 16] [--metrics-only] [--steps 10 20] [--device cuda]

The flags and the CSV columns are those of ``tools/backfill_eval.py``;
``--device`` (default ``cuda``) is the port's own. Writes one evaluation row
a checkpoint (``training_steps_{t}``, as ``cli.train`` writes them), in
step order, with a fresh Elo chain
(``alpha_zero_tpu_torch/tools/backfill_eval.py:backfill``); exits 1 when
there is no checkpoint.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alpha_zero_tpu_torch.tools.backfill_eval import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
