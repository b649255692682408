"""The program's own spans and counts (``alpha_zero_tpu_torch/utils/trace.py``)
read against a profiled stretch.

``spans_run.py`` turns the program's tracing on for the whole of each
profiled move of a traced run, so every span open during a stretch is in
its record, those opened before the profiler started too. Spans and the
profiler's events share one clock, the host's Unix nanoseconds.

- Idle time by layer: the stretch's idle intervals are the complement,
  within the traced window, of the union of the device operations'
  intervals, taken as ``trace.digest`` takes busy time and the window.
  Each idle nanosecond goes to the innermost program span open at that
  time (a span's self intervals: its interval less its children's), and
  the spans to four groups: ``scoring`` (the ``go.score`` subtree, its
  syncs included), ``net`` (the ``net`` subtree), ``search`` (every other
  program span) and ``outside`` (no span open: the benchmark's own code
  between and around steps). The four sum to the stretch's idle time.
- Counts in the stretch: the program's counts stamped inside the window.
- ``figures``: the shares and rates of the two above.
- The clock check: how far each launch of a named kernel (the runtime
  call with the kernel's correlation id) lies outside every span of a
  named kind.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

import torch

from azbench import trace as trace_lib

GROUPS = ("scoring", "search", "net", "outside")


def _events(profile):
    return profile.prof.profiler.kineto_results.events()


def window_and_busy(events) -> Tuple[int, int, List[Tuple[int, int]]]:
    """(first, last, busy): the traced window's ends and the merged device
    intervals, as ``trace.digest`` takes them."""
    first, last, device = None, None, []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        first = s if first is None or s < first else first
        last = e if last is None or e > last else last
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((s, e))
    if not device:
        return 0, 0, []
    return first, last, trace_lib._merge(device)


def idle_intervals(first: int, last: int, busy: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The complement of ``busy`` (merged, sorted) within ``[first, last]``."""
    out, t = [], first
    for s, e in busy:
        if s > t:
            out.append((t, min(s, last)))
        t = max(t, e)
    if last > t:
        out.append((t, last))
    return [(s, e) for s, e in out if e > s]


def self_segments(spans) -> List[Tuple[int, int, int]]:
    """``[(start, end, index)]`` in time order: the intervals in which span
    ``index`` is the innermost open one. Spans nest (one thread)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    out, stack, t = [], [], 0
    for i in order:
        s = spans[i].start_ns
        while stack and spans[stack[-1]].end_ns <= s:
            j = stack.pop()
            out.append((t, spans[j].end_ns, j))
            t = spans[j].end_ns
        if stack:
            out.append((t, s, stack[-1]))
        stack.append(i)
        t = s
    while stack:
        j = stack.pop()
        out.append((t, spans[j].end_ns, j))
        t = spans[j].end_ns
    return [seg for seg in out if seg[1] > seg[0]]


def span_groups(spans) -> List[str]:
    """Each span's group: ``scoring`` under ``go.score``, ``net`` under
    ``net``, else ``search``. A parent is recorded before its children."""
    groups: List[str] = []
    for s in spans:
        if s.name == "go.score":
            groups.append("scoring")
        elif s.name == "net":
            groups.append("net")
        else:
            groups.append(groups[s.parent] if s.parent >= 0 else "search")
    return groups


def attribute_idle(idle: List[Tuple[int, int]], spans) -> Dict[str, int]:
    """Idle nanoseconds by group (``GROUPS``); they sum to ``idle``'s."""
    groups = span_groups(spans)
    out = dict.fromkeys(GROUPS, 0)
    segs = self_segments(spans)
    k = 0
    for s, e in idle:
        out["outside"] += e - s
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            overlap = min(e, segs[j][1]) - max(s, segs[j][0])
            if overlap > 0:
                out[groups[segs[j][2]]] += overlap
                out["outside"] -= overlap
            j += 1
    return out


def counts_between(record, first: int, last: int) -> Dict[str, int]:
    """The record's counts stamped within ``[first, last]``, by name."""
    out: Dict[str, int] = {}
    for c in record.counts:
        if first <= c.t_ns <= last:
            out[c.name] = out.get(c.name, 0) + c.n
    return out


def launch_misses(events: Iterable, spans, kernel: str, span_name: str) -> Tuple[int, int, int]:
    """(launches, launches outside, largest miss in ns): for each device
    operation whose name holds ``kernel``, the runtime call with its
    correlation id against the ``span_name`` spans; a launch inside one
    misses by 0, else by its distance to the nearest."""
    kernels, calls = set(), {}
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if kernel in ev.name():
                kernels.add(ev.correlation_id())
        elif ev.name().startswith(("cuda", "cu")) and ev.correlation_id():
            calls[ev.correlation_id()] = (ev.start_ns(), ev.end_ns())
    iv = sorted((s.start_ns, s.end_ns) for s in spans if s.name == span_name)
    starts = [s for s, _ in iv]
    n, outside, worst = 0, 0, 0
    for corr in kernels:
        if corr not in calls:
            continue
        ls, le = calls[corr]
        i = bisect.bisect_right(starts, ls)
        miss = min((max(0, s - ls, le - e) for s, e in iv[max(0, i - 1):i + 1]),
                   default=None)
        if miss is None:
            continue
        n += 1
        outside += miss > 0
        worst = max(worst, miss)
    return n, outside, worst


def numbers(device_profile, device_record, host_profile=None, host_record=None,
            select_kernel: str = "select_leaf_kernel") -> Dict:
    """Idle time by group and the counts of the device-only stretch, and
    the clock check over both stretches; ``{}`` when the program recorded
    nothing (a program without tracing)."""
    if device_record is None or not device_record.spans:
        return {}
    events = _events(device_profile)
    first, last, busy = window_and_busy(events)
    if not busy:
        return {}
    idle = attribute_idle(idle_intervals(first, last, busy), device_record.spans)
    counts = counts_between(device_record, first, last)
    out = {f"idle_{g}_s": ns / 1e9 for g, ns in idle.items()}
    out.update(
        syncs=sum(n for name, n in counts.items() if name.startswith("sync.")),
        scored_games=counts.get("go.scored_games", 0),
        scored_boards=counts.get("go.scored_boards", 0),
        active_lane_sims=counts.get("search.active_lane_sims", 0),
        lane_sims=counts.get("search.lane_sims", 0))
    stretches = [(events, device_record)]
    if host_profile is not None and host_record is not None:
        stretches.append((_events(host_profile), host_record))
    checked = [launch_misses(ev, rec.spans, select_kernel, "search.select")
               for ev, rec in stretches]
    out.update(select_launches_checked=sum(c[0] for c in checked),
               select_launches_outside=sum(c[1] for c in checked),
               select_launch_miss_us=max(c[2] for c in checked) / 1e3)
    return out


def figures(numbers_: Dict, trace: Dict) -> Dict:
    """What the spans and counts of a run come to, beside the entry's
    ``trace`` numbers (``window_s``, ``move_scale``): each group's idle time
    as a share of the window ``device_idle_pct`` uses, and their sum; the
    ``sync.*`` counts scaled to a move as ``kernels_per_move`` is; the share
    of scored boards that needed a score; the share of evaluated lanes
    whose search was still active. ``{}`` without spans."""
    window_s = trace.get("window_s")
    if "idle_outside_s" not in numbers_ or not window_s:
        return {}
    out = {f"idle_{g}_pct": 100.0 * numbers_[f"idle_{g}_s"] / window_s for g in GROUPS}
    out["idle_sum_pct"] = sum(out[f"idle_{g}_pct"] for g in GROUPS)
    scale = trace.get("move_scale")
    out["syncs_per_move"] = numbers_["syncs"] * scale if scale else None
    boards, lanes = numbers_["scored_boards"], numbers_["lane_sims"]
    out["scoring_useful_pct"] = 100.0 * numbers_["scored_games"] / boards if boards else None
    out["net_useful_pct"] = 100.0 * numbers_["active_lane_sims"] / lanes if lanes else None
    return out
