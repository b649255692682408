"""The device trace of one profiled stretch of a run, reduced to what the
per-layer metrics read.

``Profile`` starts ``torch.profiler`` (host ops and CUDA activity) after a
synchronise, so nothing queued before it runs inside it, and stops it
after another. ``digest`` reads the raw events once: the device's
operations (kernels, copies, fills) with their times, the launch of each
(the runtime call with the same correlation id), and the host's ops. From
them it takes the seconds in which some device operation ran (the union of
their intervals), the traced window, the names of the operations that
only the named host ops launched, the device time by name, and the
longest idle gaps by the host op that was running in the middle of each.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# Host ops whose launches are the convolution's: every kernel launched
# while one of them runs (cuDNN's layout transposes too) is the conv's.
CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution",
            "aten::conv2d")


class Profile:
    """A profiled stretch: ``start()``, the work, ``stop()``. With
    ``host_ops`` the host's ops are recorded too, which slows the host a
    great deal (at go9, a 3.7 s move took 6.0 s of traced time), so the
    device's busy and idle time come from a stretch without them."""

    def __init__(self, host_ops: bool = True) -> None:
        self.prof = None
        self.host_ops = host_ops

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = []
        if self.host_ops or not torch.cuda.is_available():
            activities.append(ProfilerActivity.CPU)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Spans:
    """Host op intervals on one thread, for 'which op holds time t'."""

    def __init__(self, spans: Iterable[Tuple[int, int, str]]) -> None:
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def innermost(self, t: int) -> Optional[str]:
        """The op that started last among those running at ``t``."""
        i = bisect.bisect_right(self.starts, t)
        best = None
        # Ops nest, so walk back over the ops that started before t until
        # one that ends after t; the first such is the innermost.
        for j in range(i - 1, max(-1, i - 200), -1):
            s, e, name = self.spans[j]
            if e >= t:
                best = name
                break
        return best


def digest(profile: Profile, launch_ops: Iterable[str] = CONV_OPS) -> Dict:
    """The numbers of one profiled stretch (see the module's doc)."""
    events = profile.prof.profiler.kineto_results.events()
    device, launches, ops = [], {}, collections.defaultdict(list)
    first, last = None, None
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        first = s if first is None or s < first else first
        last = e if last is None or e > last else last
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((ev.name(), s, e, ev.correlation_id()))
        elif ev.name().startswith(("cuda", "cu")) and ev.correlation_id():
            launches[ev.correlation_id()] = (s, ev.start_thread_id())
        else:
            ops[ev.start_thread_id()].append((s, e, ev.name()))
    busy = _merge([(s, e) for _, s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    window_ns = (last - first) if device else 0

    # Which device operations the named host ops launch.
    wanted = set(launch_ops)
    held = {tid: _merge([(s, e) for s, e, n in spans if n in wanted]) for tid, spans in ops.items()}
    starts = {tid: [s for s, _ in iv] for tid, iv in held.items()}
    inside, outside = set(), set()
    for name, _, _, corr in device:
        if corr not in launches:
            outside.add(name)
            continue
        t, tid = launches[corr]
        iv = held.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        if i >= 0 and iv[i][0] <= t <= iv[i][1]:
            inside.add(name)
        else:
            outside.add(name)
    # The names only those ops launch: another trace's time of these names
    # is theirs (fills and copies that other ops launch too are not).
    launched_names = inside - outside

    by_name = collections.Counter()
    for name, s, e, _ in device:
        by_name[name] += e - s
    main = max(ops, key=lambda tid: len(ops[tid])) if ops else None
    spans = _Spans(ops.get(main, []))
    gaps = collections.Counter()
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps[spans.innermost((e0 + s1) // 2) or "(host between ops)"] += s1 - e0
    return dict(
        busy_s=busy_ns / 1e9,
        window_s=window_ns / 1e9,
        launched_names=launched_names,
        kernel_count=sum(1 for n, _, _, _ in device if not n.startswith(("Memcpy", "Memset"))),
        top_ops=[[n, ns / 1e9] for n, ns in by_name.most_common(10)],
        top_gaps=[[n, ns / 1e9] for n, ns in gaps.most_common(10)],
        by_name={n: ns / 1e9 for n, ns in by_name.items()},
        count_by_name=collections.Counter(n for n, _, _, _ in device),
    )
