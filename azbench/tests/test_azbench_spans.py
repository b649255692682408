"""``azbench/spans.py`` on synthetic device intervals and program spans:
idle time to the innermost open span, the four groups summing to the
stretch's idle time, counts in the window, the launch check, and the
figures of its numbers."""

import random

import azbench_tiny
import torch

from alpha_zero_tpu_torch.utils import trace as program_trace
from alpha_zero_tpu_torch.utils.trace import Count, Record, Span
from azbench import harness, spans, spans_run

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A stand-in for one of ``kineto_results.events()``."""

    def __init__(self, name, s, e, device=CPU, corr=0):
        self._name, self._s, self._e, self._d, self._c = name, s, e, device, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c


class Profile:
    """What ``spans`` reads of ``trace.Profile``: the profiler's events."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.prof = type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


def span(name, s, e, parent=-1):
    return Span(name, s, e, parent, -1, -1)


# selfplay.step > search.sim > go.step > go.score > sync.label_equal; net in sim.
SPANS = [span("selfplay.step", 0, 100), span("search.sim", 10, 90, 0),
         span("go.step", 20, 50, 1), span("go.score", 30, 40, 2),
         span("sync.label_equal", 32, 36, 3), span("net", 60, 80, 1)]
EVENTS = [Ev("cudaLaunchKernel", 0, 1, corr=1), Ev("k", 5, 25, CUDA, 1),
          Ev("k", 35, 55, CUDA, 2), Ev("k", 65, 85, CUDA, 3), Ev("k", 95, 100, CUDA, 4),
          Ev("cudaDeviceSynchronize", 118, 120)]


def test_window_busy_and_idle_as_digest_takes_them():
    first, last, busy = spans.window_and_busy(EVENTS)
    assert (first, last) == (0, 120)
    assert busy == [(5, 25), (35, 55), (65, 85), (95, 100)]
    assert spans.idle_intervals(first, last, busy) == [
        (0, 5), (25, 35), (55, 65), (85, 95), (100, 120)]
    assert spans.idle_intervals(0, 10, [(0, 4), (2, 10)]) == []


def test_idle_goes_to_the_innermost_span_and_its_group():
    idle = spans.idle_intervals(*spans.window_and_busy(EVENTS))
    by_group = spans.attribute_idle(idle, SPANS)
    # [0,5] step; [25,30] go.step, [30,35] go.score and its sync; [55,60]
    # sim, [60,65] net; [85,90] sim, [90,95] step; [100,120] no span.
    assert by_group == {"scoring": 5, "search": 25, "net": 5, "outside": 20}
    assert sum(by_group.values()) == 55
    assert spans.span_groups(SPANS) == ["search", "search", "search", "scoring", "scoring", "net"]


def _nested(rng, start, end, parent, out, depth):
    """Random properly nested spans inside [start, end)."""
    t = start
    while depth < 4 and t < end - 2 and rng.random() < 0.8:
        s = rng.randint(t, end - 2)
        e = rng.randint(s + 1, end)
        out.append(span(rng.choice(["search.sim", "go.step", "go.score", "net", "sync.x"]),
                        s, e, parent))
        _nested(rng, s, e, len(out) - 1, out, depth + 1)
        t = e
    return out


def test_four_groups_sum_to_idle_and_match_a_count_by_nanosecond():
    rng = random.Random(3)
    for _ in range(200):
        out = _nested(rng, 10, 190, -1, [], 0)
        events = [Ev("cuda", 0, 1, corr=1), Ev("cuda", 199, 200, corr=2)]
        for _ in range(rng.randint(0, 8)):
            s = rng.randint(0, 195)
            events.append(Ev("k", s, s + rng.randint(1, 40), CUDA))
        first, last, busy = spans.window_and_busy(events)
        got = spans.attribute_idle(spans.idle_intervals(first, last, busy), out)
        groups = spans.span_groups(out)
        want = dict.fromkeys(spans.GROUPS, 0)
        for t in range(first, last):
            if any(s <= t < e for s, e in busy):
                continue
            open_ = [i for i, x in enumerate(out) if x.start_ns <= t < x.end_ns]
            want["outside" if not open_ else groups[max(open_)]] += 1
        assert got == want
        assert sum(got.values()) == (last - first) - sum(e - s for s, e in busy)


def test_counts_in_the_window():
    record = Record([], [Count("sync.needs", 5, 1), Count("sync.needs", 50, 1),
                         Count("go.scored_games", 60, 3), Count("sync.needs", 130, 1)], 0)
    assert spans.counts_between(record, 0, 120) == {"sync.needs": 2, "go.scored_games": 3}


def test_launch_misses():
    events = [Ev("select_leaf_kernel", 40, 45, CUDA, 7), Ev("cudaLaunchKernel", 12, 14, corr=7),
              Ev("select_leaf_kernel", 60, 65, CUDA, 8), Ev("cudaLaunchKernel", 27, 29, corr=8),
              Ev("other", 70, 71, CUDA, 9), Ev("cudaLaunchKernel", 90, 91, corr=9)]
    sel = [span("search.select", 10, 15), span("search.select", 20, 22)]
    assert spans.launch_misses(events, sel, "select_leaf_kernel", "search.select") == (2, 1, 7)


def test_numbers_and_the_figures():
    counts = [Count("sync.needs", 20, 1), Count("sync.label_equal", 33, 1),
              Count("go.scored_games", 31, 3), Count("go.scored_boards", 31, 16),
              Count("search.lane_sims", 11, 16), Count("search.active_lane_sims", 11, 12),
              Count("sync.needs", 500, 1)]
    numbers = spans.numbers(Profile(EVENTS), Record(SPANS, counts, 0))
    assert numbers["syncs"] == 2 and numbers["idle_outside_s"] == 20e-9
    trace = {"busy_s": 65e-9, "window_s": 120e-9, "move_scale": 4.0}
    idle_pct = harness.load_module(harness.HERE / "metrics" / "device_idle_pct.selfplay.py").read(
        trace)
    got = spans.figures(numbers, trace)
    assert abs(got["idle_scoring_pct"] + got["idle_search_pct"] + got["idle_net_pct"]
               + got["idle_outside_pct"] - idle_pct) < 1e-9
    assert abs(got["idle_sum_pct"] - idle_pct) < 1e-9
    assert got["syncs_per_move"] == 8.0
    assert got["scoring_useful_pct"] == 100.0 * 3 / 16
    assert got["net_useful_pct"] == 75.0


def test_nothing_from_a_program_without_spans():
    assert spans.numbers(Profile(EVENTS), None) == {}
    assert spans.numbers(Profile(EVENTS), Record([], [], 0)) == {}
    assert spans.numbers(Profile([Ev("cuda", 0, 1)]), Record(SPANS, [], 0)) == {}
    assert spans.figures({}, {"window_s": 120e-9}) == {}


def test_spans_run_traces_the_profiled_moves_of_a_tiny_cell():
    """The stand-in recorder turns the program's tracing on for both
    profiled moves and off after them; the run stays correct. (On the CPU
    the profile holds no device operations, so there is no idle time.)"""
    got = spans_run.figures(azbench_tiny.run(4, trace=True))
    assert got["correct"]
    assert len(got["spans_recorded"]) == 2 and min(got["spans_recorded"]) > 0
    assert got["spans"] == {} and got["figures"] == {}
    assert program_trace.disable().spans == []


def test_spans_run_cost_plays_moves_with_tracing_off_and_on():
    got = spans_run.cost(azbench_tiny.run(4), moves=4)
    assert len(got["move_s_off"]) == len(got["move_s_on"]) == 2
    assert got["spans_a_move"] > 0 and got["counts_a_move"] > 0
    assert got["span_on_ns"] > 0 and got["count_off_ns"] > 0
    assert program_trace.disable().spans == []
