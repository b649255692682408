"""The port's own spans and counters (``alpha_zero_tpu_torch/utils/trace.py``)
on the CPU: off by default and recording nothing then, the same moves with
tracing on and off, the span tree of a search, the counters against counts
the tests make themselves, the spans on ``torch.profiler``'s clock, and
the profile tool's table of them.

9x9 Go with a one-block float32 net, 8 games, 16 simulations with reuse
and 10 new a move, games capped at 8 moves so that searches reach
finished games and score them.
"""

import dataclasses
import importlib.util
import json
import pathlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network
from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.training.pipeline import build_engine
from alpha_zero_tpu_torch.utils import trace

from torch_parity import assert_tree_equal

BATCH, SIMS, NEW_SIMS, MAX_STEPS = 8, 16, 10, 8
SIM_CHILDREN = ("search.select", "search.gather", "go.step", "search.materialize",
                "search.history", "net", "search.expand_backup")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def _setup(moves: int = 6):
    cfg = config_lib.go9()
    env = dataclasses.replace(cfg.env, max_steps=MAX_STEPS)
    net_cfg = dataclasses.replace(cfg.network, num_res_blocks=1, num_filters=8,
                                  num_fc_units=8, inference_dtype="float32")
    search = dataclasses.replace(cfg.search, num_simulations=SIMS, max_new_sims=NEW_SIMS,
                                 reuse_subtree=True)
    engine = build_engine(env)
    net = build_network(env, net_cfg, device="cpu", seed=3)
    step = selfplay.make_selfplay_step(engine, net, search, cfg.resign, device="cpu")
    gen = torch.Generator().manual_seed(7)
    sp = selfplay.init_selfplay_state(engine, BATCH, gen, -1.0, 0.0,
                                      reuse_num_simulations=SIMS, device="cpu")
    for _ in range(moves):
        sp, _ = step(sp, gen, -1.0)
    return engine, net, search, step, sp


def _clone(sp):
    return selfplay.SelfplayState(
        games=sp.games.map(torch.clone), resign_disabled=sp.resign_disabled.clone(),
        marked_resign_player=sp.marked_resign_player.clone(), trees=sp.trees.map(torch.clone))


def _children(record, index):
    return [s.name for s in record.spans if s.parent == index]


def _totals(record):
    out = {}
    for c in record.counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


def test_off_by_default_and_nothing_recorded():
    assert trace.span("a") is trace.span("b")
    assert trace.count("a", 3) is None
    _, _, _, step, sp = _setup(moves=1)
    step(sp, torch.Generator().manual_seed(1), -1.0)
    record = trace.disable()
    assert record.spans == [] and record.counts == []


def test_only_the_enabling_thread_records():
    trace.enable()
    other = threading.Thread(target=lambda: [trace.span("other").__enter__(),
                                             trace.count("other")])
    other.start()
    other.join(timeout=60)
    assert not other.is_alive()
    with trace.span("mine"):
        trace.count("mine")
    record = trace.disable()
    assert [s.name for s in record.spans] == ["mine"]
    assert [c.name for c in record.counts] == ["mine"]


def test_step_is_bit_equal_with_tracing_on_and_off():
    _, _, _, step, sp = _setup()
    outs = []
    for on in (False, True, False):
        state = _clone(sp)
        if on:
            trace.enable()
        new_sp, out = step(state, torch.Generator().manual_seed(5), -1.0)
        record = trace.disable()
        assert bool(record.spans) == on
        outs.append((out._asdict(), new_sp.trees, new_sp.games))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert_tree_equal(a, b)


def test_span_tree_of_a_move():
    _, _, _, step, sp = _setup()
    trace.enable()
    step(sp, torch.Generator().manual_seed(5), -1.0)
    record = trace.disable()
    spans = record.spans
    tops = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in tops] == ["selfplay.step"]
    assert _children(record, tops[0]) == [
        "search.root_eval", *["search.sim"] * NEW_SIMS, "search.root_stats",
        "selfplay.policy_sample", "go.step", "selfplay.reset", "search.reroot"]
    sims = [i for i, s in enumerate(spans) if s.name == "search.sim"]
    assert [(spans[i].move, spans[i].sim) for i in sims] == [(0, k) for k in range(NEW_SIMS)]
    for i in sims:
        assert sorted(_children(record, i)) == sorted(SIM_CHILDREN)
    root_eval = next(i for i, s in enumerate(spans) if s.name == "search.root_eval")
    assert _children(record, root_eval) == ["net"]
    scores = [s for s in spans if s.name == "go.score"]
    assert scores, "no search reached a finished game"
    assert all(spans[s.parent].name == "go.step" for s in scores)
    for s in spans:
        if s.name.startswith("sync."):
            assert s.name in ("sync.needs", "sync.label_equal", "sync.capture_table")
        if s.name == "sync.label_equal":
            assert spans[s.parent].name == "go.score"
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    totals = _totals(record)
    steps = sum(1 for s in spans if s.name == "go.step")
    assert totals["sync.needs"] == steps == NEW_SIMS + 1
    assert totals["sync.capture_table"] == 2 * steps
    assert totals["sync.label_equal"] == sum(1 for s in spans if s.name == "sync.label_equal")
    assert totals["search.calls"] == 1 and totals["search.lane_sims"] == BATCH * NEW_SIMS


def test_active_lane_sims_equals_the_active_lanes_of_each_simulation():
    engine, net, search, _, sp = _setup()
    eval_fn = selfplay.make_eval_fn(net)
    trees = sp.trees
    active = []

    def counting_eval(obs):
        # Called after the root evaluation once a simulation, before its
        # backup: the root's visits are those at the simulation's start.
        active.append(int((trees.node_N[:, 0] < float(SIMS)).sum()))
        return eval_fn(obs)

    trace.enable()
    mcts.batched_search(counting_eval, engine, sp.games, SIMS, root_noise=False,
                        prev_trees=trees, max_new_sims=NEW_SIMS, return_trees=True)
    record = trace.disable()
    per_sim = [c.n for c in record.counts if c.name == "search.active_lane_sims"]
    assert per_sim == active[1:]
    assert sum(per_sim) < BATCH * NEW_SIMS, "reused roots should stop early"


def test_scored_games_are_the_lanes_that_ended_on_a_scored_terminal():
    cfg = config_lib.go9()
    engine = build_engine(dataclasses.replace(cfg.env, max_steps=3))
    games = engine.init_batch(6, device="cpu")
    for move in (0, 1):
        games = engine.step_batch(games, torch.full((6,), move, dtype=torch.int32))
    games = games.replace(done=torch.tensor([False, False, True, False, False, False]))
    # The third move ends every game at max_steps: lane 2 was already over,
    # lane 3 resigns; the others are scored.
    actions = torch.tensor([2, 81, 2, -1, 5, 81], dtype=torch.int32)
    trace.enable()
    stepped = engine.step_batch(games, actions)
    record = trace.disable()
    totals = _totals(record)
    ended = stepped.done & ~stepped.resigned & ~games.done
    assert totals["go.scored_games"] == int(ended.sum()) == 4
    assert totals["go.scored_boards"] == 6 and totals["sync.needs"] == 1


def test_spans_enclose_the_profilers_events_of_their_work():
    """The spans' clock is the one ``torch.profiler`` stamps host events
    with: every convolution lies inside a ``net`` span."""
    _, _, _, step, sp = _setup()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(sp, torch.Generator().manual_seed(5), -1.0)
    record = trace.disable()
    nets = [(s.start_ns, s.end_ns) for s in record.spans if s.name == "net"]
    convs = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::conv2d"]
    assert len(convs) >= 1 + NEW_SIMS
    for s, e in convs:
        assert any(a <= s and e <= b for a, b in nets), (s, e)


def test_merge_into_chrome_trace(tmp_path):
    _, _, _, step, sp = _setup(moves=1)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(sp, torch.Generator().manual_seed(5), -1.0)
    record = trace.disable()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    trace.merge_into_chrome_trace(record, path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert len(spans) == len(record.spans)
    first = next(e for e in spans if e["name"] == "selfplay.step")
    ops = [e for e in events if e.get("name") == "aten::conv2d"]
    assert ops and all(first["ts"] <= e["ts"] <= first["ts"] + first["dur"] for e in ops)


class _Ev:
    """A stand-in for one of ``kineto_results.events()``."""

    def __init__(self, name, s, e, cuda, corr):
        self._v = (name, s, e, corr)
        self._d = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._v[3]


def test_profile_tools_phase_table_reads_the_spans():
    """``tools/profile_torch_selfplay.py``: host self time by span name,
    and each launch (and its kernel's device time) to the innermost span."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "profile_torch_selfplay.py"
    spec = importlib.util.spec_from_file_location("profile_torch_selfplay", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _, _, _, step, sp = _setup(moves=1)
    trace.enable()
    step(sp, torch.Generator().manual_seed(5), -1.0)
    record = trace.disable()
    select = next(s for s in record.spans if s.name == "search.select")
    mid = (select.start_ns + select.end_ns) // 2
    after = record.spans[0].end_ns + 10
    events = [_Ev("cudaLaunchKernel", mid, mid + 1, False, 5), _Ev("k", 0, 700, True, 5),
              _Ev("cuLaunchKernel", after, after + 1, False, 6), _Ev("k", 0, 30, True, 6)]
    table = tool.phase_table(events, record)
    assert table["search.select"][2:] == [1, 700] and table[None][2:] == [1, 30]
    assert table["search.sim"][0] == NEW_SIMS
    top = record.spans[0]
    assert sum(row[1] for row in table.values()) == top.end_ns - top.start_ns
