"""The comparison's readings on the card: the program's, and its control's.

    python3 azbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s> [--program]

Runs the cell once a seed, all in this process, with the comparison's
control in the program's place: the reference net one precision below
the configured one (fp8) as the step's net, and the visit-count policy
rounded to bf16, one precision below the configured float32. With
``--program``, the program itself. Prints one JSON line a run with every
compared number beside its limit; the control has to come out not
correct. The benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args()

    import torch

    from azbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.open_run(args.workload, seed, args.seconds, False, torch.device("cuda"),
                               t0, control=not args.program)
        out = harness.drive(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program" if args.program else "control",
                          "correct": out.correct, "checks": out.checks,
                          "env_steps_per_s": out.end_to_end["env_steps_per_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
