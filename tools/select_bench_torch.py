"""Device and host time of the select kernel K1 on real go9 trees, and of an
earlier version of it beside this one.

    python3 tools/select_bench_torch.py [--baseline ROOT] [--path-caps 1,2,4]

Grows go9 trees with the port's own search (B=1024 games, 10x128 bf16 net
with random weights from seed 0, 200 simulations, max_new_sims=120, two
self-play moves and one more search;
``alpha_zero_tpu_torch/tools/select_bench.py:grown_trees``), holds
``select_leaf_batched`` bit-equal to its plain version
``select_leaf_plain`` on the searched trees, counts the device kernels of
one call (``torch.profiler``), then times it: the device time warm and
with L2 flushed (CUDA-graph replays) and the back-to-back time with the
host's dispatch (``select_bench.py:time_select``).

With ``--baseline ROOT``, the checkout at ROOT (for example an earlier
commit unpacked with ``git archive`` into the ignored ``build/``) gives a
second ``select_leaf_batched``, built from ROOT's own kernel source into
ROOT's ``build/kernels``. Both are checked on the same trees, and timed in
turns: baseline, this one, this one, baseline. With ``--path-caps``, this
one's warm device time is also taken with each of those path caps, which
stop every descent after so many steps: the time at 1 is the launch, the
staging and one step; each further cap adds the steps of the lanes that
go that deep. Prints one line per timing and a JSON line last. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from alpha_zero_tpu_torch import config as config_lib  # noqa: E402
from alpha_zero_tpu_torch.models.resnet import build_network  # noqa: E402
from alpha_zero_tpu_torch.ops import tree_kernels  # noqa: E402
from alpha_zero_tpu_torch.tools import select_bench  # noqa: E402
from alpha_zero_tpu_torch.training.pipeline import build_engine  # noqa: E402
from alpha_zero_tpu_torch.utils.device import card_line, device_kernels, graph_ms  # noqa: E402

BATCH = 1024
REPS = 50  # calls a timing covers


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_select(root: str):
    """``select_leaf_batched`` of the checkout at ``root``, bound to that
    checkout's own build module (its ``csrc/`` and ``build/kernels``)."""
    ops = Path(root).resolve() / "alpha_zero_tpu_torch" / "ops"
    kernels = _module("baseline_tree_kernels", ops / "tree_kernels.py")
    kernels._build = _module("baseline_build", ops / "_build.py")
    return kernels.select_leaf_batched


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", help="root of another checkout to time beside this one")
    p.add_argument("--path-caps", default="", help="comma-separated caps to time this one at")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("select_bench_torch: CUDA is not available")
    card = card_line()
    dev = torch.device("cuda")
    cfg = config_lib.go9()
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device=dev, seed=0)
    trees, path_cap = select_bench.grown_trees(cfg, engine, net, BATCH, 200, 120,
                                               seed=7, device=dev)
    sargs = select_bench.select_args(trees[1])
    kw = dict(path_cap=path_cap, c_puct_base=cfg.search.c_puct_base,
              c_puct_init=cfg.search.c_puct_init)
    ref = tree_kernels.select_leaf_plain(*sargs, **kw)
    b, t, a = trees[1].child_P.shape
    bound = select_bench.select_bound(ref[6], b, t, a)
    print(f"card: {card}; go9 searched trees B={b} T={t} A={a} path_cap={path_cap}, "
          f"depth mean {ref[6].double().mean():.2f} max {int(ref[6].max())}; bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})", flush=True)

    variants = {"this": tree_kernels.select_leaf_batched}
    if args.baseline:
        variants["baseline"] = load_select(args.baseline)
    per_call = {}
    for name, select in variants.items():
        out = select(*sargs, **kw)
        torch.cuda.synchronize()
        for field, o, r in zip(select_bench.OUTPUTS, out, ref):
            if o.dtype != r.dtype or not torch.equal(o, r):
                raise SystemExit(f"{name} select != plain: {field}")
        per_call[name] = device_kernels(lambda: select(*sargs, **kw), 20)
        print(f"{name}: bit-equal to plain; device kernels per call: "
              + "; ".join(f"{k[:60]} x{n:g} ({ms * 1e3:.3f} us)"
                          for k, (n, ms) in per_call[name].items()), flush=True)

    order = ["baseline", "this", "this", "baseline"] if args.baseline else ["this", "this"]
    runs = []
    for name in order:
        times = select_bench.time_select(variants[name], sargs, kw, REPS)
        runs.append(dict(name=name, **times))
        print(f"{name}: graph {times['ms'] * 1e3:.3f} us, cold {times['cold_ms'] * 1e3:.3f} "
              f"us, back to back {times['back_to_back_ms'] * 1e3:.3f} us", flush=True)
    capped = {}
    for cap in (int(c) for c in args.path_caps.split(",") if c):
        capped[cap] = graph_ms(lambda: tree_kernels.select_leaf_batched(
            *sargs, **dict(kw, path_cap=cap)), REPS)
        print(f"this, path_cap {cap}: graph {capped[cap] * 1e3:.3f} us", flush=True)
    print(json.dumps(dict(card=card, batch=b, t=t, a=a, path_cap=path_cap,
                          depth_mean=float(ref[6].double().mean()),
                          depth_max=int(ref[6].max()), bound=bound, runs=runs,
                          path_cap_ms=capped,
                          kernels_per_call={k: {n: c for n, (c, _) in v.items()}
                                            for k, v in per_call.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
