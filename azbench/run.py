"""azbench: the benchmark of alpha_zero_tpu_torch on one NVIDIA card.

    python3 azbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(the same lines end standard error). ``setup_s`` runs from the start of
this process to the end of the warm-up. Exits non-zero, with no result,
without a CUDA card, or when the process has loaded JAX or the JAX package.

Build and kernel caches stay inside the checkout, at fixed paths under
``build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "azbench_cache" / sub)
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from azbench import harness

    run = harness.open_run(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"), T0)
    chips = run.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"azbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    print(f"# card: {card_line()}; peaks used: {harness.peaks_line()}; "
          f"{time.perf_counter() - T0:.2f}s from start to the card", file=sys.stderr, flush=True)

    out = harness.drive(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"azbench: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace:
        device_info.update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
    line = harness.result_line(run, out, device_info)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
