"""Where one self-play move of the PyTorch port spends its time.

    python3 tools/profile_torch_selfplay.py [--config go9] [--moves 3]

Runs the port's self-play step for a named config at its
``parallel.selfplay_batch_size`` games (default go9: B=1024, bf16 net with
random weights, 200 simulations, reuse, max_new_sims=120; gomoku13: 380
simulations, max_new_sims=240; go19_jumbo: B=2048, 800 simulations,
max_new_sims=480) on the GPU: one warm-up move,
``--moves`` timed moves without the profiler (their mean is the move the
device-busy share is taken against), then one move under
``torch.profiler`` with the program's own spans on
(``alpha_zero_tpu_torch/utils/trace.py``). The port's env-steps/s is the
self-play bench's, ``tools/bench_torch.py``.
The phase table reads the program's spans: for each span name, its calls,
its host self time (the spans' time less their child spans'), the kernel
launches it made (the runtime's ``cudaLaunchKernel`` and ``cuLaunchKernel``
calls whose start falls inside it and inside none of its children) and the
device time of the kernels so launched. Prints the card, the move times,
the device-busy share and kernel launches of the profiled move, the phase
table, the top kernels, and the own rows of K1 (select) and K2 (the
tree-row writer): launches and device time per launch in the move. Last,
it profiles 20 select calls on the trees the move left and prints every
device kernel of one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from alpha_zero_tpu_torch import config as config_lib  # noqa: E402
from alpha_zero_tpu_torch.models.resnet import build_network  # noqa: E402
from alpha_zero_tpu_torch.ops import tree_kernels  # noqa: E402
from alpha_zero_tpu_torch.tools import select_bench  # noqa: E402
from alpha_zero_tpu_torch.training import selfplay  # noqa: E402
from alpha_zero_tpu_torch.training.pipeline import build_engine  # noqa: E402
from alpha_zero_tpu_torch.utils import trace  # noqa: E402
from alpha_zero_tpu_torch.utils.device import card_line, device_kernels  # noqa: E402

KERNELS = {"K1": "select_leaf_kernel", "K2": "write_rows_kernel"}  # names in the trace


def _innermost(spans):
    """``at(t)``: the index of the innermost span open at ``t`` (-1 for
    none). Spans nest, so it is the latest-started span before ``t`` or one
    of its ancestors."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    starts = [spans[i].start_ns for i in order]

    def at(t: int) -> int:
        j = bisect.bisect_right(starts, t) - 1
        i = order[j] if j >= 0 else -1
        while i >= 0 and spans[i].end_ns < t:
            i = spans[i].parent
        return i

    return at


def phase_table(events, record) -> dict:
    """``{span name or None: [calls, host self ns, launches, device ns]}``
    of the program's spans over one profiled stretch (None: no span)."""
    spans = record.spans
    children = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    table = {None: [0, 0, 0, 0]}
    for i, s in enumerate(spans):
        row = table.setdefault(s.name, [0, 0, 0, 0])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns - children[i]
    at = _innermost(spans)
    launched, device = {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif "LaunchKernel" in e.name():
            i = at(e.start_ns())
            launched[e.correlation_id()] = i
            table[spans[i].name if i >= 0 else None][2] += 1
    for e in device:
        i = launched.get(e.correlation_id(), -1)
        table[spans[i].name if i >= 0 else None][3] += e.end_ns() - e.start_ns()
    return table


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="go9", choices=sorted(config_lib.CONFIGS))
    p.add_argument("--moves", type=int, default=3, help="timed moves without the profiler")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_selfplay: CUDA is not available")
    card = card_line()

    dev = torch.device("cuda")
    cfg = config_lib.get_config(args.config)
    engine = build_engine(cfg.env)
    net = build_network(cfg.env, cfg.network, device=dev, seed=0)
    step = selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = cfg.parallel.selfplay_batch_size
    sp = selfplay.init_selfplay_state(
        engine, batch, gen, -1.0, cfg.resign.disable_resign_ratio,
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
    print(f"card: {card}; {args.config}, batch {batch}; moves without profiler "
          + ", ".join(f"{x:.3f}" for x in times) + f" s: mean {plain_s:.3f} s",
          flush=True)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = move()
    record = trace.disable()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profiled move {profiled_s:.3f} s")
    print(f"profiled move: {launches} kernel launches, device busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / profiled_s:.1f}% of the "
          f"profiled move, {busy_us / 1e4 / plain_s:.1f}% of the move without it")
    table = phase_table(prof.profiler.kineto_results.events(), record)
    outside = table.pop(None)
    print(f"{'span':<24}{'calls':>7}{'host self ms':>14}{'launches':>10}{'device ms':>11}")
    for name, (calls, host_ns, launches, device_ns) in sorted(
            table.items(), key=lambda kv: -kv[1][1]):
        print(f"{name:<24}{calls:>7}{host_ns / 1e6:>14.1f}{launches:>10}{device_ns / 1e6:>11.1f}")
    print(f"outside every span: {outside[2]} launches, {outside[3] / 1e6:.1f} device ms")
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
    per_call = device_kernels(lambda: tree_kernels.select_leaf_batched(*args, **kw), 20)
    print(f"device kernels per select call: {sum(n for n, _ in per_call.values()):g}")
    for name, (n, ms) in per_call.items():
        print(f"  x{n:g} {ms * 1e3:8.3f} us  {name[:90]}")


if __name__ == "__main__":
    main()
