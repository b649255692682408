"""Row-scatter probe of the PyTorch port on one NVIDIA GPU.

    python3 tools/dma_probe_torch.py [--batch 1024] [--t 201] [--a 82] [--reps 50]

Holds the row-scatter kernels K2 and K3 bit-equal to their plain versions,
then prints per variant the mean time of ``reps`` back-to-back calls and its
device time from CUDA-graph replays, beside the bytes it must move and their
time at the card's memory rate
(``alpha_zero_tpu_torch/tools/dma_probe.py:run_probe``): one f32 array at
``[batch, t, a]`` and at ``a`` padded to a multiple of 128 (``scatter_rows``,
``scatter_rows_bulk``, the dense blend, ``index_copy_``, ``put_rows``), and
the search's two tree writes, the 13-array materialize set and the 2-array
expand set (the tree-row writer ``write_rows`` in turns with the
``put_rows`` sequence it replaced, warm and with L2 flushed, and the
writer's launch floor with every lane idle). The defaults are go9's tree
(T = 200 sims + 1, A = 82); gomoku13 is ``--t 381 --a 169``. Exits
non-zero if any variant disagrees; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alpha_zero_tpu_torch.tools.dma_probe import run_probe  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--t", type=int, default=201)
    p.add_argument("--a", type=int, default=82)
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    run_probe(args.batch, args.t, args.a, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
