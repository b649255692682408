"""Device selection for the port's entry points, and the card's peak rates
and timers its measuring code shares."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32
# operations/s outside the tensor cores and dense bf16 tensor-core
# operations/s; the L2 cache's size in bytes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
L2_BYTES = 50 * 2**20


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, to
    stand beside every number measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent,
    so an entry point never drops silently to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def time_ms(fn: Callable[[], object], reps: int, device="cuda") -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls after one
    warm-up: CUDA events on the card (the host's dispatch of each call
    included), the host clock on the CPU."""
    dev = torch.device(device)
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _replay_ms(fn: Callable[[], object], reps: int) -> float:
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int, flush_bytes: int = 0) -> float:
    """Device ms per call of ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed once to warm up, then timed over one replay with CUDA
    events. Leaves out the host's dispatch of each call. The replays run
    the recorded kernels without calling ``fn`` again, so a wrapper's
    launch count does not see them.

    With ``flush_bytes`` (more than the card's L2 cache), a write of that
    many bytes is captured before every call, and the time of the writes
    alone, from a second graph, is subtracted: the device time of a call
    that finds its inputs out of L2, as after the net's kernels."""
    fn()
    torch.cuda.synchronize()
    if not flush_bytes:
        return _replay_ms(fn, reps)
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    both = _replay_ms(lambda: (buf.fill_(1.0), fn()), reps)
    return both - _replay_ms(lambda: buf.fill_(1.0), reps)


def device_kernels(fn: Callable[[], object], calls: int) -> Dict[str, Tuple[float, float]]:
    """``{kernel name: (launches per call, device ms per launch)}`` of
    ``fn()`` over ``calls`` calls, from ``torch.profiler`` (every device-side
    event counts: kernels, memsets, copies, the caller's ``record_function``
    ranges; not the profiler's own step range). The profiler's first,
    warm-up step runs ``calls`` calls too and is not counted: the tracer
    may miss the first kernels after it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.count / calls, e.self_device_time_total / e.count / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count
            and not e.key.startswith("ProfilerStep")}
