"""The self-play entry: env-steps per second of the port's self-play step.

One run, in order:

1. Set-up. The program's config is built from the configuration file,
   and the reference module of the net it names is found
   (``harness.reference_net``). The net's weights are drawn on the device
   from the seed (the module's ``calibrated_weights``) and loaded into the
   net that ``models/resnet.py:build_network`` builds, in its inference
   dtype. The games start from the mix's random legal openings, their
   lengths spread evenly over ``[0, max_steps)``, the same games for every
   seed and shuffled over the lanes by it, so that the batch holds games
   at every stage as steady self-play does and games end, are scored and
   restart inside the window. The step is
   ``training/selfplay.py:make_selfplay_step`` over
   ``training/pipeline.py:build_engine``, on a state from
   ``init_selfplay_state`` whose games and trees are those openings. The
   kernels are built (cached under ``build/kernels``), then one warm-up
   move is played and proven by a device-to-host scalar.
2. Window. Whole moves, each proven the same way, until ``--seconds``
   have passed and the cell's ``min_moves`` are played; the window closes
   at the end of the last move. Every move takes its ``SelfplayNoise``
   (Dirichlet, Gumbel, resign uniforms) drawn from the seed just before it.
3. Comparison. For a sample of games drawn from the seed (the longest
   opening and a fresh one among them), the net's inputs and outputs at
   every evaluation and the step's outputs at every move are recorded as
   the window plays them, and judged after it by ``check``.

With ``--trace 1``, window move 0 (or the stretch of it that the cell's
``trace`` names) runs under the profiler with device activity only, and
the first evaluations of move 1 with the host's ops too; the per-layer
numbers come from them and from the other moves' times.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.ops import _build, scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from azbench import arith, harness
from azbench import trace as trace_lib
from azbench.reference import mcts as ref_mcts

# Kernel names in the device trace.
K1_KERNEL = "select_leaf_kernel"
K2_KERNEL = "write_rows_kernel"
TRANSPOSE_MARKS = ("nchwToNhwc", "nhwcToNchw")
OUT_FIELDS = ("obs", "search_pi", "to_play", "move", "root_q", "best_child_q", "root_visits",
              "done", "winner", "final_score", "game_length", "num_passes")


def note(text: str) -> None:
    print(f"# {text}", file=sys.stderr, flush=True)


def net_config(config: dict) -> dict:
    return {**config["env"], **config["network"]}


def program_config(config: dict) -> config_lib.AlphaZeroConfig:
    return config_lib.AlphaZeroConfig(
        env=config_lib.EnvConfig(**config["env"]),
        network=config_lib.NetworkConfig(**config["network"]),
        search=config_lib.SearchConfig(**config["search"]))


def search_rules(config: dict) -> ref_mcts.SearchRules:
    s = config["search"]
    return ref_mcts.SearchRules(
        num_simulations=s["num_simulations"], max_new_sims=s["max_new_sims"],
        c_puct_base=s["c_puct_base"], c_puct_init=s["c_puct_init"],
        dirichlet_eps=s["dirichlet_eps"], warm_up_steps=s["warm_up_steps"],
        warm_up_temperature=s["warm_up_temperature"], temperature=s["temperature"])


def reference_engine(config: dict):
    """(module, rules) of the reference engine of the config's game:
    ``reference/<game>.py``, whose ``rules(env)`` reads the env settings."""
    module = importlib.import_module(f"azbench.reference.{config['env']['game']}")
    return module, module.rules(config["env"])


def pack_planes(obs: np.ndarray) -> np.ndarray:
    """int32 [N, N]: observation plane c in bit c, as the step packs it."""
    bits = 1 << np.arange(obs.shape[-1], dtype=np.int64)
    return (obs.astype(np.int64) * bits).sum(-1).astype(np.int32)


class ControlNet(torch.nn.Module):
    """The comparison's control in the net's place: the reference net one
    precision below the configured one (its module's ``forward``, fp8)."""

    class Out(NamedTuple):
        pi_logits: torch.Tensor
        value: torch.Tensor

    def __init__(self, ref_net, weights: dict, cfg: dict) -> None:
        super().__init__()
        self.ref_net, self.weights, self.cfg = ref_net, weights, cfg

    def forward(self, obs):
        return self.Out(*self.ref_net.forward(self.weights, self.cfg, obs, fp8=True))


class Recorder(torch.nn.Module):
    """The net as the step sees it: records the sampled games' rows of
    every evaluation (input, logits, value) and calls ``on_eval`` first."""

    def __init__(self, net, lanes: torch.Tensor) -> None:
        super().__init__()
        self.net, self.lanes = net, lanes
        self.rows: List[tuple] = []
        self.on_eval = None

    def forward(self, obs):
        if self.on_eval is not None:
            self.on_eval()
        out = self.net(obs)
        self.rows.append((obs.index_select(0, self.lanes), out.pi_logits.index_select(0, self.lanes),
                          out.value.index_select(0, self.lanes)))
        return out


def openings(engine, batch: int, max_steps: int, opening_seed: int, seed: int, dev):
    """Games after random legal openings, the same set for every run seed:
    game i plays ``(i * max_steps) // batch`` moves, each uniform over the
    legal board points (pass, where the game has one, only when there is
    none), drawn from the mix's ``opening_seed``; the run's seed shuffles
    the games over the lanes. Returns the games, their opening lengths and
    moves ``[longest, batch]`` (-1 past a game's length), lane by lane."""
    plies = ((torch.arange(batch) * max_steps) // batch).to(dev)
    gen = torch.Generator(device=dev).manual_seed(opening_seed)
    games = engine.init_batch(batch, device=dev)
    longest = int(plies.max())
    moves = torch.full((max(longest, 1), batch), -1, dtype=torch.int32, device=dev)
    for p in range(longest):
        board_legal = games.legal[:, :engine.board_size ** 2] > 0.5
        u = torch.rand(board_legal.shape, generator=gen, device=dev)
        move = torch.where(board_legal, u, -1.0).argmax(dim=1).to(torch.int32)
        if engine.has_pass_move:
            move = torch.where(board_legal.any(dim=1), move, engine.pass_move)
        live = p < plies
        stepped = engine.step_batch(games, move)
        games = stepped.map2(games, lambda s, g: torch.where(
            live.reshape((-1,) + (1,) * (s.dim() - 1)), s, g))
        moves[p] = torch.where(live, move, -1)
    fresh = engine.init_batch(batch, device=dev)
    done = games.done
    games = fresh.map2(games, lambda f, g: torch.where(
        done.reshape((-1,) + (1,) * (f.dim() - 1)), f, g))
    order = torch.randperm(batch, generator=torch.Generator().manual_seed(
        harness.subseed(seed, "opening_order"))).to(dev)
    return games.map(lambda x: x.index_select(0, order)), plies[order], moves[:, order]


def sample_lanes(plies: torch.Tensor, count: int, seed: int) -> torch.Tensor:
    """``count`` games drawn from the seed, with the longest opening (the
    first game to end) and a fresh one among them, in increasing order."""
    p = plies.cpu()
    must = {int(p.argmax()), int(p.argmin())}
    order = torch.randperm(len(p), generator=torch.Generator().manual_seed(
        harness.subseed(seed, "lanes"))).tolist()
    picked = list(must) + [i for i in order if i not in must][:max(0, count - len(must))]
    return torch.tensor(sorted(picked[:count]))


def draw_noise(gen, batch: int, num_actions: int, alpha: float, dev) -> selfplay.SelfplayNoise:
    conc = torch.full((batch, num_actions), alpha, dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((batch, num_actions), generator=gen, device=dev)
    return selfplay.SelfplayNoise(
        dirichlet=torch._sample_dirichlet(conc, generator=gen),
        gumbel=-torch.log(-torch.log(u * (1.0 - tiny) + tiny)),
        resign_u=torch.rand((batch,), generator=gen, device=dev))


@dataclasses.dataclass
class Record:
    """The sampled games' rows of every move (device tensors until the
    window closes)."""

    legal: list = dataclasses.field(default_factory=list)
    dirichlet: list = dataclasses.field(default_factory=list)
    gumbel: list = dataclasses.field(default_factory=list)
    step_count: list = dataclasses.field(default_factory=list)
    outs: list = dataclasses.field(default_factory=list)
    eval_starts: list = dataclasses.field(default_factory=list)


def prove(sp) -> float:
    """A device-to-host scalar read from the last thing a move computes."""
    last = sp.trees.num_nodes if sp.trees is not None else sp.games.step_count
    return float(last.sum())


class Stash:
    """During a profiled stretch, K1's depths and K2's sets as the search
    hands them, read after the stretch (no kernel added inside it)."""

    def __init__(self) -> None:
        self.k1, self.k2 = [], []
        self.saved = None

    def __enter__(self):
        select, write = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
        self.saved = (select, write)

        def counted_select(*args, **kwargs):
            out = select(*args, **kwargs)
            b, t = args[0].shape
            self.k1.append((out[6], b, t, args[6].shape[-1]))
            return out

        def counted_write(arrays, rows, widx):
            write(arrays, rows, widx)
            lane = sum(r[0].numel() * r.element_size() for r in rows)
            self.k2.append((lane, widx, widx.shape[0]))

        # The wrappers count the launches: the kernels' modules bump the
        # counter of whatever their module-level name holds.
        counted_select.launches, counted_write.launches = select.launches, write.launches
        self.k1_launches = select.launches
        tree_kernels.select_leaf_batched = counted_select
        scatter_kernels.write_rows = counted_write
        return self

    def __exit__(self, *exc):
        select, write = self.saved
        counted_select, counted_write = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
        select.launches, write.launches = counted_select.launches, counted_write.launches
        tree_kernels.select_leaf_batched, scatter_kernels.write_rows = select, write
        self.k1_launches = select.launches - self.k1_launches
        return False


def run(r: harness.Run) -> harness.Outcome:
    dev = r.device
    on_card = dev.type == "cuda"
    config, cell = r.config, r.cell
    cfg = program_config(config)
    ncfg = net_config(config)
    batch = config["selfplay_batch_size"]
    sims = config["search"]["num_simulations"]
    loop_len = config["search"]["max_new_sims"]
    max_steps = config["env"]["max_steps"]
    ref_net = harness.reference_net(config)

    t = time.perf_counter()
    if on_card:
        _build.build_all()
    note(f"kernels built or found in {time.perf_counter() - t:.2f}s")
    t = time.perf_counter()
    engine = build_engine(cfg.env)
    weights = ref_net.calibrated_weights(ncfg, harness.subseed(r.seed, "weights"), dev)
    if r.control:
        net = ControlNet(ref_net, weights, ncfg)
    else:
        net = resnet.build_network(cfg.env, cfg.network, device=dev)
        missing, unexpected = net.load_state_dict(weights, strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
            raise RuntimeError(f"weights do not fit the net: {missing} {unexpected}")
    note(f"net ready in {time.perf_counter() - t:.2f}s")

    t = time.perf_counter()
    games, plies, opening_moves = openings(engine, batch, max_steps,
                                           r.traffic["opening_seed"], r.seed, dev)
    lanes = sample_lanes(plies, cell["check"]["lanes"], r.seed).to(dev)
    sp = selfplay.init_selfplay_state(
        engine, batch, None, resign_threshold=-1.0,
        disable_resign_ratio=0.0, reuse_num_simulations=sims,
        resign_u=torch.zeros(batch, device=dev), device=dev)
    sp = selfplay.SelfplayState(games=games, resign_disabled=sp.resign_disabled,
                                marked_resign_player=sp.marked_resign_player,
                                trees=mcts.make_empty_trees(engine, games, sims))
    note(f"openings of up to {int(plies.max())} moves in {time.perf_counter() - t:.2f}s")

    recorder = Recorder(net, lanes)
    step = selfplay.make_selfplay_step(engine, recorder, cfg.search, cfg.resign, device=dev)
    noise_gen = torch.Generator(device=dev).manual_seed(harness.subseed(r.seed, "noise"))
    rec = Record()
    alpha = config["search"]["dirichlet_alpha"]

    def play(sp):
        noise = draw_noise(noise_gen, batch, engine.num_actions, alpha, dev)
        rec.legal.append(sp.games.legal.index_select(0, lanes))
        rec.step_count.append(sp.games.step_count.index_select(0, lanes))
        rec.dirichlet.append(noise.dirichlet.index_select(0, lanes))
        rec.gumbel.append(noise.gumbel.index_select(0, lanes))
        rec.eval_starts.append(len(recorder.rows))
        sp, out = step(sp, None, -1.0, noise=noise)
        rec.outs.append([getattr(out, f).index_select(0, lanes) for f in OUT_FIELDS])
        return sp

    t = time.perf_counter()
    sp = play(sp)
    prove(sp)
    setup_s = time.perf_counter() - r.t0
    note(f"warm-up move {time.perf_counter() - t:.2f}s; setup_s {setup_s:.2f}")

    # With --trace 1: window move 0 (or the stretch of it the cell names)
    # under the profiler with device activity only, for the device's
    # numbers; then the first evaluations of move 1 with the host's ops
    # too, for which kernels the convolutions launch and what the host does
    # in the device's idle gaps. The other moves stay unprofiled.
    spec = cell.get("trace", {})
    plan = {0: Stretch(spec.get("first_eval", 0), spec.get("evals"), host_ops=False),
            1: Stretch(0, spec.get("ops_evals", 4), host_ops=True)} if r.trace else {}

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        stretch = plan.get(len(times))
        recorder.on_eval = stretch.on_eval if stretch else None
        try:
            sp = play(sp)
            prove(sp)
        finally:
            if stretch:
                stretch.close()
                recorder.on_eval = None
        times.append(time.perf_counter() - t)
        if (time.perf_counter() - t_start >= r.seconds
                and len(times) >= max(len(plan) + 1, cell.get("min_moves", 1))):
            break
    elapsed = time.perf_counter() - t_start
    moves = len(times)
    rate = batch * moves / elapsed
    note(f"window {elapsed:.3f}s, {moves} moves of {batch} games: {rate:.3f} env-steps/s; "
         f"move seconds {[round(x, 4) for x in times]}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    trace = None
    if r.trace:
        unprofiled = [x for i, x in enumerate(times) if i not in plan]
        trace = _trace_numbers(plan[0], plan[1], ref_net.net_layers(ncfg), batch, loop_len,
                               unprofiled)
    del sp, step, recorder.net, net
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks, failed = check(r, ref_net, weights, rec, recorder.rows, plies, opening_moves, lanes)
    note(f"comparison {time.perf_counter() - t:.2f}s")
    return harness.Outcome(end_to_end={"env_steps_per_s": rate, "setup_s": setup_s},
                           attempted=batch * moves, failed=failed, checks=checks,
                           memory_peak_bytes=peak, trace=trace)


class Stretch:
    """A profiled stretch of one move: from evaluation ``first`` of the
    move for ``count`` evaluations (None: to the move's end)."""

    def __init__(self, first: int, count, host_ops: bool) -> None:
        self.first, self.count = first, count
        self.profile = trace_lib.Profile(host_ops)
        self.stash = Stash()
        self.seen, self.evals, self.open = 0, 0, False

    def on_eval(self) -> None:
        if self.seen == self.first and not self.open:
            self.profile.start()
            self.stash.__enter__()
            self.open = True
        elif self.count is not None and self.seen == self.first + self.count:
            self.close()
        self.seen += 1

    def close(self) -> None:
        if self.open:
            self.profile.stop()
            self.stash.__exit__(None, None, None)
            self.open = False
            self.evals = self.seen - self.first


def _trace_numbers(device: Stretch, host: Stretch, layers, batch, loop_len, unprofiled) -> Dict:
    """What the per-layer readers take from the two profiled stretches and
    the unprofiled moves; ``layers`` is the net's ``net_layers``."""
    t = time.perf_counter()
    tr = trace_lib.digest(device.profile)
    ops = trace_lib.digest(host.profile)
    k1_count = sum(c for n, c in tr["count_by_name"].items() if K1_KERNEL in n)
    if k1_count != device.stash.k1_launches:
        raise RuntimeError(f"the trace holds {k1_count} {K1_KERNEL} kernels but "
                           f"{device.stash.k1_launches} were launched: the profiler lost events; "
                           "profile a shorter stretch (the cell's trace.evals)")
    k1_bound = sum(arith.select_bound(float(d.sum()), b, t_, a)["bound_s"]
                   for d, b, t_, a in device.stash.k1)
    k2_bound = arith.rows_bound((lane, int((w >= 0).sum()), b) for lane, w, b in device.stash.k2)
    net_flops = arith.net_flops(layers) * batch * (1 + loop_len)

    def seconds(names):
        return sum(s for n, s in tr["by_name"].items() if n in names)

    conv_names = ops["launched_names"]
    out = dict(
        busy_s=tr["busy_s"], window_s=tr["window_s"], kernel_count=tr["kernel_count"],
        move_scale=loop_len / device.stash.k1_launches if device.stash.k1_launches else None,
        transpose_s=seconds({n for n in tr["by_name"] if any(m in n for m in TRANSPOSE_MARKS)}),
        conv_launched_s=seconds(conv_names) if conv_names else 0.0,
        conv_flops=arith.conv_flops(layers) * batch * device.evals,
        conv_bytes=arith.conv_bytes(layers, batch) * device.evals,
        k1_device_s=seconds({n for n in tr["by_name"] if K1_KERNEL in n}),
        k1_bound_s=k1_bound,
        k2_device_s=seconds({n for n in tr["by_name"] if K2_KERNEL in n}),
        k2_bound_s=k2_bound,
        mfu_flops=net_flops * len(unprofiled), mfu_seconds=sum(unprofiled),
        top_ops=tr["top_ops"], top_gaps=ops["top_gaps"])
    note(f"kernels the convolutions launch: {sorted(conv_names)}")
    note(f"trace: {device.evals} evaluations, {tr['kernel_count']} kernels, {k1_count} K1 "
         f"launches; digest {time.perf_counter() - t:.2f}s; numbers "
         + str({k: v for k, v in out.items() if not isinstance(v, list)}))
    return out


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


class Diverged(Exception):
    pass


def check(r: harness.Run, ref_net, weights, rec: Record, rows, plies, opening_moves, lanes):
    """Judges the sampled games' moves and every net evaluation of them,
    the latter against ``ref_net``, the net's reference module; returns
    (checks, failed lane-moves)."""
    dev = r.device
    config, limits = r.config, r.cell["limits"]
    obs = torch.stack([o for o, _, _ in rows], dim=1)           # [k, E, N, N, C]
    logits = torch.stack([lg for _, lg, _ in rows], dim=1)      # [k, E, A]
    values = torch.stack([v for _, _, v in rows], dim=1)        # [k, E]
    k, e = values.shape

    # The net: every recorded evaluation against the float32 reference.
    # A sample of them, drawn from the seed, when the cell bounds the rows.
    ncfg = net_config(config)
    prior = F.softmax(logits.float(), dim=-1)
    flat = torch.arange(k * e)
    limit = r.cell["check"].get("net_rows")
    if limit is not None and limit < k * e:
        flat = torch.randperm(k * e, generator=torch.Generator().manual_seed(
            harness.subseed(r.seed, "net_rows")))[:limit].sort().values
    flat = flat.to(dev)
    ref_logits, ref_values = ref_net.evaluate(
        weights, ncfg, obs.reshape((k * e,) + obs.shape[2:]).index_select(0, flat),
        block=r.cell["check"].get("net_block", 1024))
    gap = (prior.reshape(k * e, -1).index_select(0, flat) - F.softmax(ref_logits, dim=-1)).abs()
    policy_tv = float(0.5 * gap.sum(dim=-1).mean())
    value_err = (values.reshape(-1).index_select(0, flat) - ref_values).abs()
    value_mae = float(value_err.mean())
    note(f"net: {flat.numel()} evaluations; widest prior gap {float(gap.max()):.6g}, "
         f"widest value gap {float(value_err.max()):.6g}")

    # The search and the engine: each game replayed by the reference.
    outs = [[x.cpu().numpy() for x in o] for o in rec.outs]
    if r.control:
        # The control computes the visit-count policy one precision lower.
        for o in outs:
            o[1] = torch.from_numpy(o[1]).to(torch.bfloat16).float().numpy()
    moves = [dict(zip(OUT_FIELDS, o)) for o in outs]
    legal = [x.cpu().numpy() for x in rec.legal]
    dirichlet = [x.cpu().numpy() for x in rec.dirichlet]
    gumbel = [x.cpu().numpy() for x in rec.gumbel]
    steps = [x.cpu().numpy() for x in rec.step_count]
    obs_h, prior_h, values_h = obs.cpu().numpy(), prior.cpu().numpy(), values.cpu().numpy()
    plies_h = plies.index_select(0, lanes).cpu().numpy()
    openings_h = opening_moves.index_select(1, lanes).cpu().numpy()
    srules, (game, grules) = search_rules(config), reference_engine(config)
    pb_c, sqrt_n = ref_mcts.tables(srules, dev)

    engine_bad, search_bad, pi_gap = 0, 0, 0.0
    for j in range(k):
        e_bad, s_bad, gap = _replay(j, srules, game, grules, pb_c, sqrt_n, plies_h[j],
                                    openings_h[:, j], moves, legal, dirichlet, gumbel, steps,
                                    rec.eval_starts, obs_h[j], prior_h[j], values_h[j])
        engine_bad += e_bad
        search_bad += s_bad
        pi_gap = max(pi_gap, gap)
    checks = {
        "engine_mismatches": {"value": engine_bad, "limit": 0},
        "search_mismatches": {"value": search_bad, "limit": 0},
        "search_pi_gap": {"value": pi_gap, "limit": limits["search_pi_gap"]},
        "policy_tv": {"value": policy_tv, "limit": limits["policy_tv"]},
        "value_mae": {"value": value_mae, "limit": limits["value_mae"]},
    }
    return checks, engine_bad + search_bad


def _replay(j, srules, game, grules, pb_c, sqrt_n, plies, opening, moves, legal, dirichlet, gumbel,
            steps, eval_starts, obs, prior, values):
    """One sampled game: its opening, then every recorded move. Returns
    (engine mismatches, 1 if the search diverged, widest policy gap)."""
    pos = game.Position(grules)
    for p in range(int(plies)):
        if pos.done:
            break
        if pos.legal()[opening[p]] != 1.0:
            return 1, 0, 0.0
        pos = pos.play(int(opening[p]))
    if pos.done:
        pos = game.Position(grules)

    engine_bad, search_ok, gap, tree = 0, True, 0.0, None
    for m, out in enumerate(moves):
        root_ok = (np.array_equal(legal[m][j], pos.legal())
                   and np.array_equal(out["obs"][j], pack_planes(pos.observation()))
                   and out["to_play"][j] == pos.to_play and steps[m][j] == pos.step_count)
        if not root_ok:
            return engine_bad + 1, int(not search_ok), gap
        mv = int(out["move"][j])
        if search_ok:
            base = eval_starts[m]

            def evaluate(sim, leaf_obs, base=base):
                row = base + 1 + sim
                if leaf_obs is not None and not np.array_equal(leaf_obs, obs[row]):
                    raise Diverged
                return prior[row], values[row]

            try:
                res = ref_mcts.search(srules, pos, tree, dirichlet[m][j], evaluate, pb_c, sqrt_n)
                pi = ref_mcts.policy(srules, res.child_N, pos.legal(), pos.step_count)
                ref_move = ref_mcts.sample(srules, pi, pos.legal(), gumbel[m][j], pos.step_count,
                                           grules.pass_move)
                n, w = res.child_N[mv], res.child_W[mv]
                best_q = -(w / max(n, np.float32(1.0))) if n > 0 else np.float32(0.0)
                if (ref_move != mv or np.float32(1.0) + res.child_N.sum(dtype=np.float32)
                        != out["root_visits"][j] or res.root_Q != out["root_q"][j]
                        or best_q != out["best_child_q"][j]):
                    raise Diverged
                gap = max(gap, float(np.abs(pi - out["search_pi"][j]).max()))
            except Diverged:
                search_ok = False
        if pos.legal()[mv] != 1.0:
            return engine_bad + 1, int(not search_ok), gap
        after = pos.play(mv)
        if bool(out["done"][j]) != after.done or (after.done and (
                int(out["winner"][j]) != after.winner
                or np.float32(out["final_score"][j]) != np.float32(after.final_score)
                or int(out["game_length"][j]) != after.step_count
                or int(out["num_passes"][j]) != after.num_passes)):
            engine_bad += 1
        tree = ref_mcts.reroot(tree, res, mv, after) if search_ok else None
        pos = game.Position(grules) if after.done else after
    return engine_bad, int(not search_ok), gap
