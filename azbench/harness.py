"""What every cell shares: finding a cell's files by name, the run's
seeds, the per-layer readers, and the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
cell's own file is ``workloads/<cell>.json``, the configuration's
``configs/<config>.json``, the mix's ``traffic/<traffic>.json``; the mix
names the entry, ``entries/<entry>.py``, whose ``run(run)`` drives the
program and returns an ``Outcome``. The configuration names its game,
whose reference engine is ``reference/<game>.py``, and its net, whose
reference is ``reference/nets/<net>.py`` (``reference_net``):
``calibrated_weights(cfg, seed, device, rows=256)``, a state dict under the
port's names; ``forward(w, cfg, obs, fp8=False, calibrate=False)`` in
float32 with TF32 off, and with ``fp8=True`` the comparison's control;
``evaluate(w, cfg, obs, fp8=False, block=1024)``; and ``net_layers(cfg)``,
the (convs, denses) that ``arith`` counts (``reference/nets/__init__.py``).
The program's net is the one the port's ``models/resnet.py:build_network``
builds from the configuration's ``network``. Each per-layer metric is
read by ``metrics/<metric>.py:read(trace)``, which returns a number, or
None when the trace holds nothing for it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import pkgutil
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded by a run: JAX and the JAX
# package the port was made from (compared whole, so the port's own name,
# which begins with the latter, is not one of them).
FORBIDDEN = ("jax", "jaxlib", "flax", "alpha_zero_tpu")


def peaks_line() -> str:
    from azbench import arith

    return (f"bf16 {arith.BF16_FLOPS_PER_S:.4g} FLOP/s, float32 {arith.F32_FLOPS_PER_S:.4g} "
            f"FLOP/s, HBM {arith.HBM_BYTES_PER_S:.4g} B/s (H100 SXM data sheet, at 700 W)")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The module in ``path``; its name is its path under the benchmark."""
    name = "azbench_" + path.relative_to(HERE).as_posix().replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reference_net(config: dict) -> ModuleType:
    """The reference module of the net that ``config`` names,
    ``azbench.reference.nets.<net>``; ends the run if there is none."""
    import azbench.reference.nets as nets

    net = config.get("net")
    module = f"{nets.__name__}.{net}"
    if isinstance(net, str) and net.isidentifier() and not net.startswith("_"):
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    present = sorted(m.name for m in pkgutil.iter_modules(nets.__path__)
                     if not m.name.startswith("_"))
    raise SystemExit(f"the configuration names net {net!r}, which has no module "
                     f"{module}: the nets present are {present}")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Run:
    """One run of one cell, as the command line and the files give it."""

    name: str
    seed: int
    seconds: float
    trace: bool
    bench: dict      # BENCHMARK.json
    entry: dict      # the cell's entry in BENCHMARK.json
    cell: dict       # workloads/<name>.json
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    device: object   # torch.device
    t0: float        # time.perf_counter() at process start
    control: bool = False  # the comparison's control in the program's place

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports."""
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", self._reporting(m["moves"]))]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def _reporting(self, metric: str) -> List[str]:
        for m in self.bench["end_to_end"]:
            if m["name"] == metric:
                return m.get("workloads", [w["name"] for w in self.bench["workloads"]])
        return []


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: its end-to-end numbers, the trace numbers
    the readers take, and the comparison."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]  # name -> {"value", "limit"}
    memory_peak_bytes: int
    trace: Optional[dict] = None         # what metrics/<name>.py read

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def open_run(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> Run:
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    return Run(name=name, seed=seed, seconds=seconds, trace=trace, bench=bench, entry=entry,
               cell=load_json(HERE / "workloads" / f"{name}.json"),
               config=load_json(HERE / "configs" / f"{entry['config']}.json"),
               traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
               device=device, t0=t0, control=control)


def drive(run: Run) -> Outcome:
    """Runs the cell's entry."""
    return load_module(HERE / "entries" / f"{run.traffic['entry']}.py").run(run)


def read_per_layer(run: Run, trace: dict) -> Dict[str, dict]:
    out = {}
    for m in run.per_layer():
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(run: Run, out: Outcome, device_info: dict) -> dict:
    """The last line of a run, keys in the contract's order; the compared
    numbers come last, each beside its limit."""
    if run.trace:
        metrics = read_per_layer(run, out.trace)
    else:
        units = {m["name"]: m["unit"] for m in run.end_to_end()}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.end_to_end.items()
                   if k in units}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if run.trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace["top_ops"],
                             "idle_gaps": out.trace["top_gaps"]}
    line["checks"] = out.checks
    return line
