"""Root-visit distribution of the PyTorch port's self-play under subtree
reuse, on one NVIDIA GPU.

    B=1024 WARM=50 STEPS=20 [MAX_NEW_SIMS=...] [CONFIG=go9] [DEVICE=cuda] \
        python3 tools/visits_hist_torch.py

The environment variables and the report are those of
``tools/visits_hist.py``; ``DEVICE`` (default ``cuda``) is the port's own.
Plays ``WARM`` + ``STEPS`` self-play moves of ``B`` games with the config's
net at random weights of seed 0 and prints the distribution of the root's
final visit count over the last ``STEPS`` moves
(``alpha_zero_tpu_torch/tools/visits_hist.py``).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alpha_zero_tpu_torch.tools.visits_hist import main  # noqa: E402

if __name__ == "__main__":
    main()
