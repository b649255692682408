"""A self-play cell small enough for the CPU: 5x5 Go, a 2 x 16 net in
float32, 16 simulations with reuse and 10 new a move, 16 games."""

import time

import torch

from azbench import harness

LIMITS = {"search_pi_gap": 1e-4, "policy_tv": 0.03, "value_mae": 0.03}


def config(dtype: str = "float32", batch: int = 16) -> dict:
    return {
        "net": "resnet",
        "env": {"game": "go", "board_size": 5, "num_stack": 8, "komi": 7.5, "max_steps": 50},
        "network": {"num_res_blocks": 2, "num_filters": 16, "num_fc_units": 16, "gomoku": False,
                    "inference_dtype": dtype},
        "search": {"num_simulations": 16, "c_puct_base": 19652.0, "c_puct_init": 1.25,
                   "dirichlet_eps": 0.25, "dirichlet_alpha": 0.03, "warm_up_steps": 4,
                   "warm_up_temperature": 1.0, "temperature": 0.1, "reuse_subtree": True,
                   "max_new_sims": 10},
        "selfplay_batch_size": batch,
    }


def run(seed: int, seconds: float = 1.0, control: bool = False, trace: bool = False,
        dtype: str = "float32", batch: int = 16, lanes: int = 6) -> harness.Run:
    """A ``harness.Run`` of the tiny cell on the CPU."""
    cell = {"check": {"lanes": lanes}, "trace": {}, "limits": dict(LIMITS)}
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return harness.Run(name="go9.selfplay", seed=seed, seconds=seconds, trace=trace, bench=bench,
                       entry={"chips": 1}, cell=cell, config=config(dtype, batch),
                       traffic={"entry": "selfplay", "opening_seed": 5}, device=torch.device("cpu"),
                       t0=time.perf_counter(), control=control)
