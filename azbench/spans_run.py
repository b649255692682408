"""The program's own spans and counts (``alpha_zero_tpu_torch/utils/trace.py``)
in a self-play cell on the card, until the entry reads them itself.

    python3 azbench/spans_run.py --workload <cell> --seed <n> --seconds <s> \
        [--what figures|syncs|cost] [--moves <n>]

``figures`` (the default) runs the cell as ``run.py --trace 1`` does, with
the program's tracing on for the whole of each profiled move, and prints
one JSON line: the run's per-layer metrics, ``correct``, what
``spans.numbers`` makes of the spans and counts (idle time by group, the
counts, K1's launches against the ``search.select`` spans) and
``spans.figures`` of them. The entry does not turn the program's tracing
on itself: here a stand-in for its recorder turns it on when the entry
hands the recorder a profiled stretch, before the move, and off when it
takes it back, after the move; a wrapper of the entry's ``_trace_numbers``
reads the record against the two stretches.

``syncs`` plays the cell's warm-up move, then one move with tracing on
under ``torch.cuda.set_sync_debug_mode("warn")``, and prints the
synchronizing calls it reported, by site, beside the program's ``sync.*``
counts. ``cost`` plays ``--moves`` moves after the warm-up, with tracing
off and on in turn (off, on, on, off, ...) and the profiler off, and
prints each move's host time, the spans and counts a move records, and
the host time of one span and one count on and off.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def entry_of(r):
    from azbench import harness

    return harness.load_module(harness.HERE / "entries" / f"{r.traffic['entry']}.py")


def figures(r) -> dict:
    """The traced run ``r`` of a self-play cell with the program's tracing
    on for its profiled moves, and what its spans and counts come to."""
    from alpha_zero_tpu_torch.utils import trace as program_trace
    from azbench import harness, spans

    entry = entry_of(r)

    class Recorder(entry.Recorder):
        """The entry's recorder, with the program's tracing on while it
        holds a profiled stretch's ``on_eval``."""

        stretch = None

        @property
        def on_eval(self):
            return self.__dict__.get("_on_eval")

        @on_eval.setter
        def on_eval(self, fn):
            if fn is not None and self.stretch is None:
                self.stretch = fn.__self__
                program_trace.enable()
            elif fn is None and self.stretch is not None:
                self.stretch.record = program_trace.disable()
                self.stretch = None
            self.__dict__["_on_eval"] = fn

    got, recorded = {}, []
    trace_numbers = entry._trace_numbers

    def traced_numbers(device, host, *rest):
        got.update(spans.numbers(device.profile, device.record, host.profile, host.record))
        recorded.extend(len(s.record.spans) for s in (device, host))
        return trace_numbers(device, host, *rest)

    entry.Recorder, entry._trace_numbers = Recorder, traced_numbers
    out = entry.run(r)  # what harness.drive does, on this copy of the entry
    metrics = {k: v["value"] for k, v in harness.read_per_layer(r, out.trace).items()}
    return {"workload": r.name, "seed": r.seed, "correct": out.correct, "metrics": metrics,
            "spans_recorded": recorded, "spans": got, "figures": spans.figures(got, out.trace)}


def cell_step(r):
    """(play, prove, sp) over the cell's net, openings and noise, as the
    entry sets them up, after the warm-up move; ``play(sp)`` is one move."""
    import torch

    from alpha_zero_tpu_torch.models import resnet
    from alpha_zero_tpu_torch.ops import _build
    from alpha_zero_tpu_torch.search import mcts
    from alpha_zero_tpu_torch.training import selfplay
    from alpha_zero_tpu_torch.training.pipeline import build_engine
    from azbench import harness

    entry = entry_of(r)
    on_card = r.device.type == "cuda"
    dev, config = r.device, r.config
    cfg, ncfg = entry.program_config(config), entry.net_config(config)
    ref_net = harness.reference_net(config)
    batch, sims = config["selfplay_batch_size"], config["search"]["num_simulations"]
    if on_card:
        _build.build_all()
    engine = build_engine(cfg.env)
    net = resnet.build_network(cfg.env, cfg.network, device=dev)
    net.load_state_dict(ref_net.calibrated_weights(ncfg, harness.subseed(r.seed, "weights"), dev),
                        strict=False)
    games, _, _ = entry.openings(engine, batch, config["env"]["max_steps"],
                                 r.traffic["opening_seed"], r.seed, dev)
    sp = selfplay.init_selfplay_state(
        engine, batch, None, resign_threshold=-1.0, disable_resign_ratio=0.0,
        reuse_num_simulations=sims, resign_u=torch.zeros(batch, device=dev), device=dev)
    sp = selfplay.SelfplayState(games=games, resign_disabled=sp.resign_disabled,
                                marked_resign_player=sp.marked_resign_player,
                                trees=mcts.make_empty_trees(engine, games, sims))
    step = selfplay.make_selfplay_step(engine, net, cfg.search, cfg.resign, device=dev)
    gen = torch.Generator(device=dev).manual_seed(harness.subseed(r.seed, "noise"))
    alpha = config["search"]["dirichlet_alpha"]

    def play(sp):
        noise = entry.draw_noise(gen, batch, engine.num_actions, alpha, dev)
        return step(sp, None, -1.0, noise=noise)[0]

    sp = play(sp)
    entry.prove(sp)
    return play, entry.prove, sp


def sync(r) -> None:
    import torch

    if r.device.type == "cuda":
        torch.cuda.synchronize()


def syncs(r) -> dict:
    """One move of ``r``'s cell under the sync debug mode, with tracing on."""
    import torch

    from alpha_zero_tpu_torch.utils import trace as program_trace

    play, prove, sp = cell_step(r)
    sync(r)
    program_trace.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sp = play(sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    record = program_trace.disable()
    prove(sp)
    root = str(Path(__file__).resolve().parents[1]) + "/"
    sites = collections.Counter(f"{w.filename.replace(root, '')}:{w.lineno}" for w in caught
                                if "synchronizing" in str(w.message))
    counted = collections.Counter()
    for c in record.counts:
        if c.name.startswith("sync."):
            counted[c.name] += c.n
    return {"workload": r.name, "seed": r.seed,
            "debug_mode_syncs": sum(sites.values()), "by_site": dict(sites),
            "program_syncs": sum(counted.values()), "by_name": dict(counted)}


def cost(r, moves: int) -> dict:
    """``moves`` moves of ``r``'s cell, tracing off and on in turn, and the
    cost of one span and one count."""
    from alpha_zero_tpu_torch.utils import trace as program_trace

    play, prove, sp = cell_step(r)
    times = {False: [], True: []}
    made = []
    for i in range(moves):
        on = i % 4 in (1, 2)
        sync(r)
        t = time.perf_counter()
        if on:
            program_trace.enable()
        sp = play(sp)
        prove(sp)
        if on:
            record = program_trace.disable()
        times[on].append(time.perf_counter() - t)
        if on:
            made.append((len(record.spans), len(record.counts)))

    def per_call(fn, n=200_000):
        t = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t) / n

    def one_span():
        with program_trace.span("x"):
            pass

    def one_count():
        program_trace.count("x")

    costs = {"span_off_ns": per_call(one_span), "count_off_ns": per_call(one_count)}
    program_trace.enable()
    costs.update(span_on_ns=per_call(one_span), count_on_ns=per_call(one_count))
    program_trace.disable()
    spans_a_move = statistics.median(s for s, _ in made)
    counts_a_move = statistics.median(c for _, c in made)
    off, on = statistics.median(times[False]), statistics.median(times[True])
    estimate = (spans_a_move * costs["span_on_ns"] + counts_a_move * costs["count_on_ns"]) / 1e9
    return {"workload": r.name, "seed": r.seed, "move_s_off": times[False],
            "move_s_on": times[True], "median_off_s": off, "median_on_s": on,
            "median_ratio": on / off, "spans_a_move": spans_a_move,
            "counts_a_move": counts_a_move, **costs,
            "estimated_cost_pct": 100.0 * estimate / off}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--what", choices=("figures", "syncs", "cost"), default="figures")
    p.add_argument("--moves", type=int, default=12, help="timed moves of --what cost")
    args = p.parse_args()
    from azbench import run as run_py  # sets the run's cache paths, as run.py has them

    import torch

    from azbench import harness

    if not torch.cuda.is_available():
        print("spans_run: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"# card: {run_py.card_line()}; torch {torch.__version__}", file=sys.stderr, flush=True)
    r = harness.open_run(args.workload, args.seed, args.seconds, args.what == "figures",
                         torch.device("cuda"), T0)
    if args.what == "figures":
        out = figures(r)
    elif args.what == "syncs":
        out = syncs(r)
    else:
        out = cost(r, args.moves)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
