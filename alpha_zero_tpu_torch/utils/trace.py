"""Spans and counters inside the program, for traced runs.

    from alpha_zero_tpu_torch.utils import trace

    trace.enable()
    ...                                  # with trace.span("search.select"): ...
    record = trace.disable()             # record.spans, record.counts

Tracing is off by default. Off, ``span`` returns one shared no-op context
manager and ``count`` returns at once: the off path allocates nothing,
launches nothing on the device and reads nothing back from it.
``enable()`` starts a recording; ``disable()`` ends it and hands it over.
Nothing is written anywhere while it runs. Only the thread that called
``enable()`` records (the Trainer's evaluator thread searches too).

A span records its name, its start and end in integer nanoseconds of
``time.time_ns()`` (the Unix clock, which ``torch.profiler`` stamps its
host events with), the index of the span that was open around it (its
parent; -1 for none) and, for a search simulation, the search's and the
simulation's numbers. A count records its name, its time on the same
clock and its amount. An amount may be a device tensor: it stays on the
device, and ``disable()`` reads all of them at once.

The module computes no metric: whoever reads a recording does. One
exporter, ``merge_into_chrome_trace``, adds a recording to a Chrome trace
that ``torch.profiler`` wrote.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Union

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int   # index of the enclosing span in ``Record.spans``; -1 for none
    move: int     # the search's number since ``enable()`` (``search.sim`` only; else -1)
    sim: int      # the simulation's number in its search (``search.sim`` only; else -1)


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


class Record(NamedTuple):
    spans: List[Span]
    counts: List[Count]
    tid: int      # native id of the thread that recorded


class _Off:
    """The context manager every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Recording:
    """Columns of plain values: no container a span or count, so the
    collector has nothing new to scan."""

    def __init__(self) -> None:
        self.names: List[str] = []   # spans: name, start, end, parent, move, sim
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.parents: List[int] = []
        self.moves: List[int] = []
        self.sims: List[int] = []
        self.open: List[int] = []    # indices of the spans open now, innermost last
        self.count_names: List[str] = []
        self.count_ts: List[int] = []
        self.amounts: list = []      # host ints or device tensors
        self.totals: Dict[str, int] = {}  # of host amounts, for ``count``'s return
        self.thread = threading.get_ident()
        self.tid = threading.get_native_id()


class _Span:
    __slots__ = ("rec", "name", "move", "sim", "index")

    def __init__(self, rec: _Recording, name: str, move: int, sim: int) -> None:
        self.rec, self.name, self.move, self.sim = rec, name, move, sim

    def __enter__(self):
        rec = self.rec
        self.index = len(rec.names)
        rec.names.append(self.name)
        rec.parents.append(rec.open[-1] if rec.open else -1)
        rec.moves.append(self.move)
        rec.sims.append(self.sim)
        rec.ends.append(0)
        rec.open.append(self.index)
        rec.starts.append(time.time_ns())
        return self

    def __exit__(self, *exc) -> bool:
        self.rec.ends[self.index] = time.time_ns()
        self.rec.open.pop()
        return False


_rec: Optional[_Recording] = None


def enable() -> None:
    """Starts a new recording (dropping one that was not handed over)."""
    global _rec
    _rec = _Recording()


def disable() -> Record:
    """Ends the recording and returns it; device amounts are read here, in
    one transfer a device. Empty when tracing was off."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        return Record([], [], threading.get_native_id())
    amounts = rec.amounts
    on_device: Dict[torch.device, List[int]] = {}
    for i, n in enumerate(amounts):
        if type(n) is not int:
            on_device.setdefault(n.device, []).append(i)
    for idx in on_device.values():
        values = torch.stack([amounts[i].reshape(()).to(torch.int64) for i in idx]).tolist()
        for i, v in zip(idx, values):
            amounts[i] = v
    spans = list(map(Span, rec.names, rec.starts, rec.ends, rec.parents, rec.moves, rec.sims))
    return Record(spans, list(map(Count, rec.count_names, rec.count_ts, amounts)), rec.tid)


def span(name: str, move: int = -1, sim: int = -1):
    """A context manager that records ``name`` over its block while
    tracing is on; the shared no-op one while it is off."""
    rec = _rec
    if rec is None or threading.get_ident() != rec.thread:
        return _OFF
    return _Span(rec, name, move, sim)


def count(name: str, n: Union[int, torch.Tensor] = 1) -> Optional[int]:
    """Adds ``n`` to the counter ``name``. Returns, while tracing is on and
    ``n`` is a host int, the counter's total before this add (None else)."""
    rec = _rec
    if rec is None or threading.get_ident() != rec.thread:
        return None
    rec.count_names.append(name)
    rec.count_ts.append(time.time_ns())
    rec.amounts.append(n)
    if type(n) is not int:  # a device amount (isinstance on a tensor costs a microsecond)
        return None
    before = rec.totals.get(name, 0)
    rec.totals[name] = before + n
    return before


def merge_into_chrome_trace(record: Record, path: str) -> None:
    """Adds the recording's spans (complete events, category
    ``program_span``) and counts (counter events, ``program_counter``) to
    the Chrome trace at ``path`` that ``torch.profiler`` exported, on the
    trace's own time base. The events go in as text at the head of its
    ``traceEvents`` list: a trace of a few hundred MB is not parsed."""
    with open(path) as f:
        text = f.read()
    base = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', text)
    base = int(base.group(1)) if base else 0
    events = []
    for i, s in enumerate(record.spans):
        args = {"index": i, "parent": s.parent}
        if s.sim >= 0:
            args.update(move=s.move, sim=s.sim)
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": os.getpid(),
                       "tid": record.tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    running: Dict[str, int] = {}
    for c in record.counts:
        running[c.name] = running.get(c.name, 0) + c.n
        events.append({"ph": "C", "cat": "program_counter", "name": c.name, "pid": os.getpid(),
                       "tid": record.tid, "ts": (c.t_ns - base) / 1e3,
                       "args": {"total": running[c.name]}})
    head = re.search(r'"traceEvents"\s*:\s*\[\s*', text)
    if head is None:
        raise ValueError(f"{path} holds no traceEvents list")
    at = head.end()
    joined = ",\n".join(json.dumps(e) for e in events)
    if joined and text[at] != "]":
        joined += ",\n"
    with open(path, "w") as f:
        f.write(text[:at] + joined + text[at:])
