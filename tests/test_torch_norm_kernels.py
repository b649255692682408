"""K5's wrapper on the CPU (``ops/norm_kernels.py``): CPU tensors take the
plain version, the eval chain the nets ran before K5, whose bits the kernel
is held to on the card (``tests/test_torch_cuda.py``); and the nets' norm
helpers (``models/resnet.py``) route every CPU norm to the plain ops."""

import pytest
import torch

from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.ops import norm_kernels as nk
from alpha_zero_tpu_torch.tools import norm_bench
from alpha_zero_tpu_torch.utils import trace


def _chain(mode, x, bn, res):
    """The formulation the blocks wrote out before K5."""
    if mode == nk.NORM_RELU:
        return None, torch.relu(bn(x))
    if mode == nk.NORM_ADD_RELU:
        return None, torch.relu(bn(x) + res)
    s = x + res
    return s, torch.relu(bn(s))


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_chain(variant, dtype):
    x, res = norm_bench.make_inputs(3, 5, 16, "cpu", seed=2)
    x, res = x.to(dtype), res.to(dtype)
    bn = norm_bench.make_bn(16, "cpu", seed=4)
    mode = norm_bench.VARIANTS[variant]
    r = None if mode == nk.NORM_RELU else res
    before = nk.norm_act.launches
    s, out = nk.norm_act(mode, x, bn, r)
    want_s, want = _chain(mode, x, bn, r)
    assert torch.equal(out, want) and out.dtype == dtype
    assert (s is None) == (want_s is None) and (s is None or torch.equal(s, want_s))
    assert nk.norm_act(mode, x, bn, r, keep_sum=False)[0] is None
    assert nk.norm_act.launches == before


def test_plain_chain_normalizes_with_the_running_statistics():
    """``norm_act_plain`` is the eval chain whatever the module's mode: a
    train-mode module's batch statistics are neither used nor updated."""
    x, _ = norm_bench.make_inputs(2, 5, 8, "cpu")
    bn = norm_bench.make_bn(8, "cpu")
    want = _chain(nk.NORM_RELU, x, bn, None)[1]
    mean = bn.running_mean.clone()
    bn.train()
    assert torch.equal(nk.norm_act_plain(nk.NORM_RELU, x, bn)[1], want)
    assert torch.equal(bn.running_mean, mean)


def test_net_helpers_on_the_cpu_are_the_plain_ops():
    """``norm_relu``, ``norm_add_relu`` and ``add_norm_relu`` on the CPU, in
    eval and train mode: the plain ops (through the module, so train mode
    normalizes with the batch and updates the statistics), each norm
    counted as ``net.plain_norms``."""
    x, res = norm_bench.make_inputs(2, 5, 16, "cpu", seed=5)
    for train in (False, True):
        bn, twin = (norm_bench.make_bn(16, "cpu", seed=6).train(train) for _ in range(2))
        trace.enable()
        try:
            got = [resnet.norm_relu(bn, x), resnet.norm_add_relu(bn, x, res),
                   *resnet.add_norm_relu(x, res, bn)]
        finally:
            record = trace.disable()
        want = [_chain(nk.NORM_RELU, x, twin, None)[1],
                _chain(nk.NORM_ADD_RELU, x, twin, res)[1], *_chain(nk.ADD_NORM_RELU, x, twin, res)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(bn.running_var, twin.running_var)
        assert [(c.name, c.n) for c in record.counts] == [("net.plain_norms", 1)] * 3
