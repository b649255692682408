"""Self-play throughput of the PyTorch port on one NVIDIA GPU: env-steps/s.

    [BENCH_CONFIG=go9|gomoku13|go19_jumbo] [BENCH_BATCH=1024] [BENCH_SIMS=200] \
    [BENCH_STEPS=8] [BENCH_WARMUP=1] [BENCH_REUSE=0|1] [BENCH_MAX_NEW_SIMS=120] \
    [BENCH_DP=2] [BENCH_DEVICE=cuda] python3 tools/bench_torch.py

The environment variables and the JSON lines on stdout are those of
``bench.py``: one line after every timed move, ``"partial": true`` on all
but the last, which is the result. ``BENCH_DEVICE`` (default ``cuda``) is
the port's own; ``cpu`` runs on the CPU, at a micro size only. ``BENCH_DP=n``
splits the games over n ranks on this host. Notes on stderr start with
``#``: the kernels' build, the warm-up, each move's rate, the summary, the
K1/K2 launches of each timed move and the peak memory beside the card
(``alpha_zero_tpu_torch/tools/bench.py``).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alpha_zero_tpu_torch.tools.bench import main  # noqa: E402

if __name__ == "__main__":
    main()
