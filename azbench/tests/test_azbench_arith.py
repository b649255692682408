"""The yardstick's arithmetic against independent counts: the net's
operations against PyTorch's FlopCounterMode on the port's net, and K1's
and K2's bytes against the port's own measuring tools."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.tools import dma_probe, select_bench
from azbench import arith, harness
from azbench.reference.nets import resnet as ref_resnet


@pytest.mark.parametrize("name", ["go9", "go19_jumbo"])
def test_net_flops_match_flop_counter(name):
    data = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg = {**data["env"], **data["network"]}
    program = config_lib.get_config(data["program_config"])
    net = resnet.build_network(program.env, program.network, device="cpu", dtype="float32")
    obs = torch.zeros((2, cfg["board_size"], cfg["board_size"], 2 * cfg["num_stack"] + 1),
                      dtype=torch.int8)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(obs)
    counts = counter.get_flop_counts()["Global"]
    convs = sum(v for k, v in counts.items() if "convolution" in str(k))
    layers = ref_resnet.net_layers(cfg)
    assert arith.conv_flops(layers) * 2 == convs
    assert arith.net_flops(layers) * 2 == counter.get_total_flops()


def test_conv_bytes_count_each_tensor_once():
    cfg = {"board_size": 9, "num_stack": 8, "num_filters": 128, "num_fc_units": 128,
           "num_res_blocks": 10}
    stem = 17 * 81 + 128 * 17 * 9 + 128 * 81
    block = 128 * 81 + 128 * 128 * 9 + 128 * 81
    heads = (128 * 81 + 2 * 128 + 2 * 81) + (128 * 81 + 128 + 81)
    assert arith.conv_bytes(ref_resnet.net_layers(cfg), 1) == 2 * (stem + 20 * block + heads)


@pytest.mark.parametrize("b,t,a", [(1024, 201, 82), (512, 801, 362), (3, 17, 26)])
def test_select_bound_matches_the_ports_tool(b, t, a):
    depth = torch.randint(1, 12, (b,), generator=torch.Generator().manual_seed(b))
    ours = arith.select_bound(float(depth.sum()), b, t, a)
    theirs = select_bench.select_bound(depth, b, t, a)
    assert ours["bytes"] == theirs["bytes"] and ours["ops"] == theirs["ops"]
    assert ours["bound_s"] == pytest.approx(theirs["bound_ms"] / 1e3, rel=1e-12)


@pytest.mark.parametrize("b,t,a", [(1024, 201, 82), (64, 801, 362)])
def test_rows_bytes_match_the_ports_set_bytes(b, t, a):
    sets = dma_probe.tree_sets(b, t, a, torch.Generator().manual_seed(0), "cpu")
    for arrays, rows in sets.values():
        lane = sum(r[0].numel() * r.element_size() for r in rows)
        assert arith.rows_bytes(lane, b, b) == dma_probe.set_bytes(b, rows)
        assert arith.rows_bytes(lane, b // 2, b) < dma_probe.set_bytes(b, rows)
