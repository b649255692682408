"""The nbt net's reference (``reference/nets/nbt.py``): its counts against
``FlopCounterMode``, its weights in the port's net, its forward against the
port's net in float32, its residual branches drawn at ``branch_scale``, and
a tiny self-play cell on it, traced and correct, with its control not
correct."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import azbench_tiny
from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models.resnet import build_network
from azbench import arith, harness
from azbench.reference.nets import calibration_boards, nbt

TINY_NETWORK = {"architecture": "nbt", "num_res_blocks": 4, "num_filters": 32,
                "nbt_mid_channels": 16, "nbt_gpool_channels": 8, "nbt_gpool_blocks": "2",
                "nbt_policy_channels": 8, "nbt_policy_gpool_channels": 8,
                "nbt_value_channels": 16, "num_fc_units": 16, "gomoku": False}


def _tiny(dtype: str = "float32", batch: int = 16) -> dict:
    data = azbench_tiny.config(dtype, batch)
    data["net"] = "nbt"
    data["network"] = {**TINY_NETWORK, "inference_dtype": dtype}
    return data


def _configs():
    return {"tiny": _tiny(),
            "go19_b18c384nbt": harness.load_json(harness.HERE / "configs" / "go19_b18c384nbt.json")}


def _port_configs(data: dict):
    return (config_lib.EnvConfig(**data["env"]),
            config_lib.NetworkConfig(**{**data["network"], "inference_dtype": "float32"}))


@pytest.mark.parametrize("name", ["tiny", "go19_b18c384nbt"])
def test_net_flops_are_flop_counter_modes(name):
    data = _configs()[name]
    cfg = {**data["env"], **data["network"]}
    w = nbt.make_weights(cfg, 1, "cpu")
    n, planes = cfg["board_size"], 2 * cfg["num_stack"] + 1
    with FlopCounterMode(display=False) as counter:
        nbt.forward(w, cfg, torch.zeros((1, n, n, planes), dtype=torch.int8))
    layers = nbt.net_layers(cfg)
    assert arith.net_flops(layers) == counter.get_total_flops()
    convs, denses = layers
    if name == "go19_b18c384nbt":
        assert (len(convs), len(denses)) == (118, 10)
        assert arith.net_flops(layers) == 18_935_588_800


@pytest.mark.parametrize("name", ["tiny", "go19_b18c384nbt"])
def test_calibrated_weights_load_into_the_ports_net(name):
    data = _configs()[name]
    cfg = {**data["env"], **data["network"]}
    env, net_cfg = _port_configs(data)
    net = build_network(env, net_cfg, device="cpu")
    missing, unexpected = net.load_state_dict(nbt.calibrated_weights(cfg, 7, "cpu", rows=8),
                                              strict=False)
    assert (missing, unexpected) == ([], [])


def test_forward_is_the_ports_float32_net():
    """The same equations in float32, the port's through its modules and
    eval-mode ``F.batch_norm``, in other op orders: 1e-5 of the largest
    logit bounds their rounding (~1e-6)."""
    data = _tiny()
    cfg = {**data["env"], **data["network"]}
    w = nbt.calibrated_weights(cfg, 11, "cpu", rows=64)
    net = build_network(*_port_configs(data), device="cpu")
    net.load_state_dict(w, strict=False)
    obs = calibration_boards(cfg, 16, 99, "cpu")
    with torch.no_grad():
        logits, value = nbt.forward(w, cfg, obs)
        out = net(obs)
    torch.testing.assert_close(out.pi_logits, logits, rtol=0.0,
                               atol=1e-5 * float(logits.abs().max()))
    torch.testing.assert_close(out.value, value, rtol=0.0, atol=1e-5)
    assert float(logits.std(dim=1).mean()) > 0.1 and float(value.abs().max()) < 0.99


def test_residual_branches_end_at_branch_scale():
    """Every residual branch's last conv, and no other kernel, is drawn
    within 1 / sqrt(blocks) of the Kaiming bound, and reaches near it."""
    cfg = {**_tiny()["env"], **_tiny()["network"]}
    w = nbt.make_weights(cfg, 3, "cpu")
    kernels, _ = nbt.layout(cfg)
    ends = [name for name, _ in kernels if name.endswith(nbt.BRANCH_ENDS)]
    assert len(ends) == 3 * cfg["num_res_blocks"]
    for name, shape in kernels:
        bound = (6.0 / torch.tensor(shape[1:]).prod().item()) ** 0.5
        if name in ends:
            bound *= nbt.branch_scale(cfg)
        top, size = float(w[name].abs().max()), w[name].numel()
        assert top <= bound and (size < 64 or top > 0.8 * bound), name


def test_tiny_cell_is_correct_traced_and_its_control_is_not():
    r = azbench_tiny.run(4, trace=True)
    r.config = _tiny()
    out = harness.drive(r)
    assert out.correct, out.checks
    assert out.trace["conv_flops"] > 0 and out.trace["mfu_flops"] > 0

    r = azbench_tiny.run(5, control=True, dtype="bfloat16", batch=24)
    r.config = _tiny("bfloat16", 24)
    out = harness.drive(r)
    assert not out.correct, out.checks
