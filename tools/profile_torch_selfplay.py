"""Where one self-play move of the PyTorch port spends its time.

    python3 tools/profile_torch_selfplay.py [--config go9] [--moves 3] [--rate-only]

Runs the port's self-play step for a named config (default go9: B=1024
games, bf16 net with random weights, 200 simulations, reuse,
max_new_sims=120; gomoku13: 380 simulations, max_new_sims=240) on the
GPU: one warm-up move,
``--moves`` timed moves without the profiler (their mean gives env-steps/s),
then one move under ``torch.profiler`` (skipped with ``--rate-only``).
The search's phases are wrapped in ``record_function`` ranges by this script
(the port itself carries no instrumentation), so the table gives, per phase,
the host time inside its calls and the span its work covers on the device
(idle gaps included). Prints the card, the move times, the device-busy share
and kernel launches of the profiled move, the phase table (with the
kernel launches each phase makes, counted from the ``cudaLaunchKernel``
and ``cuLaunchKernel`` calls under its range), the top kernels, and the
own rows of K1 (select) and K2 (the tree-row writer): launches and device
time per launch in the move. Last, it profiles 20 select calls on the
trees the move left and prints every device kernel of one call. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from alpha_zero_tpu_torch import config as config_lib  # noqa: E402
from alpha_zero_tpu_torch.models.resnet import build_network  # noqa: E402
from alpha_zero_tpu_torch.ops import tree_kernels  # noqa: E402
from alpha_zero_tpu_torch.search import mcts  # noqa: E402
from alpha_zero_tpu_torch.tools import select_bench  # noqa: E402
from alpha_zero_tpu_torch.training import selfplay  # noqa: E402
from alpha_zero_tpu_torch.training.pipeline import build_engine  # noqa: E402
from alpha_zero_tpu_torch.utils.device import card_line, device_kernels  # noqa: E402

BATCH = 1024
KERNELS = {"K1": "select_leaf_kernel", "K2": "write_rows_kernel"}  # names in the trace
PHASES = ("select", "gather_state", "engine_step", "materialize", "history",
          "net", "expand_backup", "reroot")


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _instrument(engine_cls) -> None:
    """Wraps each phase of the search in a named profiler range."""
    tree_kernels.select_leaf_batched = _ranged("select", tree_kernels.select_leaf_batched)
    mcts._gather_state_rows = _ranged("gather_state", mcts._gather_state_rows)
    engine_cls.step_batch = _ranged("engine_step", engine_cls.step_batch)
    mcts._materialize_scatter = _ranged("materialize", mcts._materialize_scatter)
    mcts._leaf_history_batch = _ranged("history", mcts._leaf_history_batch)
    mcts._expand_backup_scatter = _ranged("expand_backup", mcts._expand_backup_scatter)
    mcts.reroot_trees = _ranged("reroot", mcts.reroot_trees)
    make_eval_fn = selfplay.make_eval_fn
    selfplay.make_eval_fn = lambda net: _ranged("net", make_eval_fn(net))


def _launches_per_phase(events) -> dict:
    """``{phase or None: kernel launches}``: every ``cudaLaunchKernel`` or
    ``cuLaunchKernel`` call (and their variants), under the innermost phase
    range around it."""
    counts = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or "LaunchKernel" not in e.name:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in PHASES:
            parent = parent.cpu_parent
        key = None if parent is None else parent.name
        counts[key] = counts.get(key, 0) + 1
    return counts


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="go9", choices=sorted(config_lib.CONFIGS))
    p.add_argument("--moves", type=int, default=3, help="timed moves without the profiler")
    p.add_argument("--rate-only", action="store_true", help="no profiled move")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_selfplay: CUDA is not available")
    card = card_line()

    dev = torch.device("cuda")
    cfg = config_lib.get_config(args.config)
    engine = build_engine(cfg.env)
    _instrument(type(engine))
    net = build_network(cfg.env, cfg.network, device=dev, seed=0)
    step = selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = selfplay.init_selfplay_state(
        engine, BATCH, gen, -1.0, cfg.resign.disable_resign_ratio,
        reuse_num_simulations=cfg.search.num_simulations, device=dev)

    def move():
        nonlocal sp
        torch.cuda.synchronize()
        t0 = time.time()
        sp, _ = step(sp, gen, -1.0)
        torch.cuda.synchronize()
        return time.time() - t0

    move()  # warm-up
    times = [move() for _ in range(args.moves)]
    plain_s = sum(times) / len(times)
    print(f"card: {card}; {args.config}, batch {BATCH}; moves without profiler "
          + ", ".join(f"{x:.3f}" for x in times) + f" s: mean {plain_s:.3f} s, "
          f"{BATCH / plain_s:.1f} env-steps/s", flush=True)
    if args.rate_only:
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = move()
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if e.key not in PHASES]
    spans = {e.key: e for e in on_device if e.key in PHASES}
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profiled move {profiled_s:.3f} s")
    print(f"profiled move: {launches} kernel launches, device busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / profiled_s:.1f}% of the "
          f"profiled move, {busy_us / 1e4 / plain_s:.1f}% of the move without it")
    launched = _launches_per_phase(prof.events())
    print(f"{'phase':<14}{'calls':>7}{'host ms':>10}{'device span ms':>16}{'launches':>10}")
    host = [e for e in events if e.key in PHASES and e not in on_device]
    for e in sorted(host, key=lambda e: -e.cpu_time_total):
        span = spans[e.key].device_time_total / 1e3 if e.key in spans else 0.0
        print(f"{e.key:<14}{e.count:>7}{e.cpu_time_total / 1e3:>10.1f}{span:>16.1f}"
              f"{launched.get(e.key, 0):>10}")
    print(f"launches outside the phases: {launched.get(None, 0)}")
    print("top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")
    for e in kernels:
        for label, name in KERNELS.items():
            if name in e.key:
                print(f"{label} {e.key} in the move: {e.count} launches, "
                      f"{e.self_device_time_total / 1e3:.2f} ms, "
                      f"{e.self_device_time_total / e.count:.3f} us per launch")

    # Every device kernel of one select call, on the trees the move left.
    kw = dict(path_cap=min(cfg.search.num_simulations + 1, engine.max_steps + 2),
              c_puct_base=cfg.search.c_puct_base, c_puct_init=cfg.search.c_puct_init)
    args = select_bench.select_args(sp.trees)
    per_call = {name: v for name, v in device_kernels(
        lambda: tree_kernels.select_leaf_batched(*args, **kw), 20).items()
        if name not in PHASES}  # not the profiler range around select
    print(f"device kernels per select call: {sum(n for n, _ in per_call.values()):g}")
    for name, (n, ms) in per_call.items():
        print(f"  x{n:g} {ms * 1e3:8.3f} us  {name[:90]}")


if __name__ == "__main__":
    main()
