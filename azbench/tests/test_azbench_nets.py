"""A configuration names its net, and the harness reaches the net only
through ``reference/nets/<net>.py``: the counts and the weights as they
were when the ResNet's reference was the only one, a name with no module
refused at set-up, and a second net reached through a new file alone."""

import importlib.util
import sys

import pytest

import azbench_tiny
import azbench.reference.nets
from alpha_zero_tpu_torch.models import resnet
from azbench import arith, harness

CONTRACT = ("calibrated_weights", "forward", "evaluate", "net_layers")
NETS = harness.HERE / "reference" / "nets"

# net_flops, conv_flops and conv_bytes at the cell's batch, computed by
# azbench/arith.py when it still built the ResNet's layers itself.
COUNTS = {
    "go9": (4096, 481039816.0, 480992256.0, 3671399424.0),
    "go19_jumbo": (512, 16211953128.0, 16211245056.0, 7528384512.0),
}

# The float64 sum of each tensor of the tiny configuration's calibrated
# weights for seed 123 on the CPU, taken when the ResNet's reference was
# azbench/reference/net.py. Kernels and BN affine parameters are drawn and
# set elementwise; the running statistics are float32 means of a
# convolution's output, which other CPU libraries may round differently.
TINY_SUMS = {
    "stem_conv.weight": 2.6532776890526293, "blocks.0.conv1.weight": -6.181410361619783,
    "blocks.0.conv2.weight": 0.8194406556613103, "blocks.1.conv1.weight": 3.160328260535607,
    "blocks.1.conv2.weight": 3.170914516922494, "policy_conv.weight": 0.7509403694421053,
    "policy_fc.weight": -1.2306321741489228, "value_conv.weight": -3.3252512477338314,
    "value_fc1.weight": -2.5906445680884644, "value_fc2.weight": 0.5783749353140593,
    "policy_fc.bias": 0.0, "value_fc1.bias": 0.0, "value_fc2.bias": 0.0,
    "stem_bn.weight": 16.0, "stem_bn.bias": 0.0,
    "stem_bn.running_mean": 0.5996104497462511, "stem_bn.running_var": 3.3616746813058853,
    "blocks.0.bn1.weight": 16.0, "blocks.0.bn1.bias": 0.0,
    "blocks.0.bn1.running_mean": -1.7362475086702034,
    "blocks.0.bn1.running_var": 10.216569662094116,
    "blocks.0.bn2.weight": 16.0, "blocks.0.bn2.bias": 0.0,
    "blocks.0.bn2.running_mean": -0.35320243053138256,
    "blocks.0.bn2.running_var": 9.634051948785782,
    "blocks.1.bn1.weight": 16.0, "blocks.1.bn1.bias": 0.0,
    "blocks.1.bn1.running_mean": 2.0330595783889294,
    "blocks.1.bn1.running_var": 22.396498441696167,
    "blocks.1.bn2.weight": 16.0, "blocks.1.bn2.bias": 0.0,
    "blocks.1.bn2.running_mean": 0.944631720893085,
    "blocks.1.bn2.running_var": 9.85498633980751,
    "policy_bn.weight": 2.0, "policy_bn.bias": 0.0,
    "policy_bn.running_mean": 0.6889803409576416, "policy_bn.running_var": 4.4941627979278564,
    "value_bn.weight": 1.0, "value_bn.bias": 0.0,
    "value_bn.running_mean": -2.9126062393188477, "value_bn.running_var": 3.715857982635498,
}

# Appended to a copy of nets/resnet.py: every call of the contract's
# functions is recorded in the copy's CALLS.
TWIN_TAIL = '''

CALLS = []


def _counted(fn):
    def counted(*args, **kwargs):
        CALLS.append(fn.__name__ + (".fp8" if kwargs.get("fp8") else ""))
        return fn(*args, **kwargs)
    return counted


calibrated_weights, forward, evaluate, net_layers = (
    _counted(f) for f in (calibrated_weights, forward, evaluate, net_layers))
'''


def _config(name: str) -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_the_parents(name):
    data = _config(name)
    batch, net_flops, conv_flops, conv_bytes = COUNTS[name]
    assert data["selfplay_batch_size"] == batch
    layers = harness.reference_net(data).net_layers({**data["env"], **data["network"]})
    assert arith.net_flops(layers) == net_flops
    assert arith.conv_flops(layers) == conv_flops
    assert arith.conv_bytes(layers, batch) == conv_bytes


def test_tiny_weights_are_the_parents():
    data = azbench_tiny.config()
    w = harness.reference_net(data).calibrated_weights({**data["env"], **data["network"]}, 123,
                                                        "cpu")
    assert set(w) == set(TINY_SUMS)
    for name, want in TINY_SUMS.items():
        got = float(w[name].double().sum())
        if "running_" in name:
            assert got == pytest.approx(want, rel=1e-6, abs=1e-6), name
        else:
            assert got == pytest.approx(want, rel=1e-12, abs=0.0), name


@pytest.mark.parametrize("net", ["no_such_net", "__init__", None])
def test_a_net_with_no_module_ends_the_run_at_set_up(monkeypatch, net):
    def unreached(*args, **kwargs):
        raise AssertionError("the run went past set-up")

    monkeypatch.setattr(resnet, "build_network", unreached)
    r = azbench_tiny.run(3)
    if net is None:
        del r.config["net"]
    else:
        r.config["net"] = net
    with pytest.raises(SystemExit, match=r"the nets present are \['resnet'\]") as ended:
        harness.drive(r)
    assert repr(net) in str(ended.value)


def test_a_second_net_is_reached_through_its_module_alone(monkeypatch, tmp_path):
    """A copy of nets/resnet.py under another name, from outside the tree,
    put where the lookup finds a net, with the tree's module unreachable:
    the entry's weights, counts, comparison and control all come from the
    copy."""
    name = "azbench.reference.nets.twin"
    (tmp_path / "twin.py").write_text((NETS / "resnet.py").read_text() + TWIN_TAIL)
    spec = importlib.util.spec_from_file_location(name, tmp_path / "twin.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    monkeypatch.setitem(sys.modules, name, twin)
    monkeypatch.setitem(sys.modules, "azbench.reference.nets.resnet", None)
    monkeypatch.delattr(azbench.reference.nets, "resnet", raising=False)

    r = azbench_tiny.run(4, trace=True)
    r.config["net"] = "twin"
    out = harness.drive(r)
    assert out.correct, out.checks
    assert out.trace["conv_flops"] > 0
    assert {"calibrated_weights", "evaluate", "net_layers"} <= set(twin.CALLS)
    assert "forward.fp8" not in twin.CALLS

    twin.CALLS.clear()
    r = azbench_tiny.run(5, control=True, dtype="bfloat16", batch=24)
    r.config["net"] = "twin"
    assert not harness.drive(r).correct
    assert {"calibrated_weights", "forward.fp8", "evaluate"} <= set(twin.CALLS)


@pytest.mark.parametrize("path", sorted((harness.HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_config_names_a_net_that_resolves(path):
    data = harness.load_json(path)
    net = harness.reference_net(data)
    assert all(hasattr(net, name) for name in CONTRACT)
    convs, denses = net.net_layers({**data["env"], **data["network"]})
    assert convs and denses

