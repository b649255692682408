"""The train-mode BatchNorm that recomputes its float32 work in backward
(``models/resnet.py:_TrainBatchNorm``) against the formulation it
replaced, kept here as ``_kept_forward``: the same float32 ops with
autograd keeping their intermediates (the cast input and ``x - mean``,
two float32 copies of every activation).

- One layer, in float32, in bf16 and under bf16 autocast: the output, the
  input, weight and bias gradients and the running statistics bit-equal.
- A 2-3 block net at 9x9 and 19x19 through ``learner.loss_fn`` in float32
  and bf16: the losses, every gradient and every running statistic
  bit-equal after two steps of SGD.
- ``saved_tensors_hooks`` over a bf16 forward: no saved float32 tensor of
  an activation's shape, and the bytes kept a residual block a sample at
  most half of the kept formulation's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alpha_zero_tpu_torch import config as config_lib
from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.models.resnet import BatchNorm, build_network
from alpha_zero_tpu_torch.parallel.mesh import Mesh
from alpha_zero_tpu_torch.training import learner

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)


def _kept_forward(self, x):
    """The train-mode forward before the recompute: autograd keeps the
    float32 intermediates of every op."""
    if not self.training:
        return torch.nn.BatchNorm2d.forward(self, x)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
    return y.to(x.dtype)


@pytest.fixture
def kept(monkeypatch):
    """Runs ``fn()`` with the kept formulation in place of the recompute."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(BatchNorm, "forward", _kept_forward)
            return fn()
    return run


def _layer(c, seed):
    rng = np.random.RandomState(seed)
    bn = BatchNorm(c, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return bn


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "autocast"])
def test_layer_is_bit_equal_to_the_kept_formulation(kept, mode):
    rng = np.random.RandomState(3)
    x0 = torch.from_numpy((rng.randn(6, 8, 5, 5) * 2 + 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(6, 8, 5, 5).astype(np.float32))
    if mode == "bfloat16":
        x0, g = x0.bfloat16(), g.bfloat16()

    def run():
        bn = _layer(8, seed=4)
        x = x0.clone().requires_grad_(True)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=mode == "autocast"):
            # Under autocast the layer's input is a bf16 conv output.
            inp = x.bfloat16() if mode == "autocast" else x
            y = bn(inp)
        y.backward(g.to(y.dtype))
        return y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var

    ref, got = kept(run), run()
    for name, r, o in zip(("y", "x.grad", "weight.grad", "bias.grad", "running_mean",
                           "running_var"), ref, got):
        _assert_equal(r, o, name)
    assert got[0].dtype == (torch.bfloat16 if mode != "float32" else torch.float32)


def _net_configs(board_size, blocks, dtype):
    cfg = config_lib.go9()
    env = dataclasses.replace(cfg.env, board_size=board_size, num_stack=2)
    net = dataclasses.replace(cfg.network, num_res_blocks=blocks, num_filters=16,
                              num_fc_units=16, inference_dtype=dtype)
    return env, net, cfg.train


def _batch(env, batch, seed):
    rng = np.random.RandomState(seed)
    states = (rng.rand(batch, env.board_size, env.board_size, env.num_planes) < 0.3)
    logits = rng.randn(batch, env.num_actions)
    pi = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    values = rng.choice([-1.0, 0.0, 1.0], size=batch)
    return (torch.from_numpy(states.astype(np.int8)), torch.from_numpy(pi.astype(np.float32)),
            torch.from_numpy(values.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("board_size,blocks", [(9, 2), (19, 3)])
def test_net_steps_are_bit_equal_to_the_kept_formulation(kept, dtype, board_size, blocks):
    """Two SGD steps through ``loss_fn``: the losses, every gradient, the
    weights and the running statistics bit-equal."""
    env, net_cfg, train_cfg = _net_configs(board_size, blocks, dtype)
    compute = getattr(torch, dtype)

    def run():
        state = learner.create_train_state(
            build_network(env, net_cfg, device="cpu", seed=2, dtype="float32"), train_cfg)
        record = []
        for step in range(2):
            losses = learner.loss_fn(state.net, *_batch(env, 8, step), compute)
            state.optimizer.zero_grad(set_to_none=True)
            sum(losses).backward()
            record.append(([l.detach() for l in losses],
                           {n: p.grad.clone() for n, p in state.net.named_parameters()}))
            state.optimizer.step()
        return record, state.net.state_dict()

    (ref_steps, ref_state), (steps, state) = kept(run), run()
    for (ref_losses, ref_grads), (losses, grads) in zip(ref_steps, steps):
        for r, o in zip(ref_losses, losses):
            _assert_equal(r, o, "loss")
        for name in ref_grads:
            _assert_equal(ref_grads[name], grads[name], f"grad of {name}")
    for name in ref_state:
        _assert_equal(ref_state[name], state[name], name)
    assert not torch.equal(state["stem_bn.running_var"], torch.ones(16))


def _saved(net, states):
    """The tensors a bf16-autocast forward in train mode keeps for backward,
    by storage (a tensor kept twice counts once): [(shape, dtype, bytes)]."""
    seen = {}

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.dtype, tuple(t.shape))
        seen.setdefault(key, (tuple(t.shape), t.dtype, t.untyped_storage().nbytes()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            out = net(states)
    del out
    return list(seen.values())


def _block_bytes(kept_or_none, board_size, batch):
    """Saved bytes a residual block a sample: the difference between nets
    of 3 and 2 blocks, over the batch; and the 3-block net's saved list."""
    def measure(blocks):
        env, net_cfg, _ = _net_configs(board_size, blocks, "bfloat16")
        net = build_network(env, net_cfg, device="cpu", seed=0, dtype="float32").train()
        states = _batch(env, batch, 0)[0]
        return _saved(net, states)

    def both():
        return measure(3), measure(2)

    three, two = both() if kept_or_none is None else kept_or_none(both)
    per_block = (sum(b for *_, b in three) - sum(b for *_, b in two)) / batch
    return per_block, three


@pytest.mark.parametrize("board_size", [9, 19])
def test_no_float32_activation_is_saved_under_bf16_autocast(kept, board_size):
    batch, filters = 8, 16
    per_block, saved = _block_bytes(None, board_size, batch)
    activation = (batch, filters, board_size, board_size)
    f32 = [s for s in saved if s[1] == torch.float32 and s[0] == activation]
    assert not f32, f32
    kept_block, kept_saved = _block_bytes(kept, board_size, batch)
    # The kept formulation does keep them: two a BatchNorm layer.
    assert sum(s[1] == torch.float32 and s[0] == activation for s in kept_saved) >= 2 * 3 * 2
    assert per_block <= 0.5 * kept_block, (per_block, kept_block)


def test_data_group_sums_are_replayed_not_reduced_again(monkeypatch):
    """With more than one model group, the backward's recompute takes the
    forward's reduced sums (``all_reduce_sum(..., reduced)``): the forward
    collective runs once a layer, the gradient's once. A stand-in for the
    data group doubles every sum, as two ranks holding the same rows do,
    which leaves the moments those of the local batch."""
    calls = []

    class Dist:
        @staticmethod
        def all_reduce(t, group=None):
            calls.append(tuple(t.shape))
            t.mul_(2.0)

    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 4, 5, 5).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 4, 5, 5).astype(np.float32))
    local = _layer(4, seed=5)
    y_local = local(x)
    monkeypatch.setattr(resnet.multihost, "dist", Dist)
    monkeypatch.setattr(resnet.multihost, "mesh", lambda: Mesh(dp=2, mdl=1))
    bn = _layer(4, seed=5)
    y = bn(x.clone().requires_grad_(True))
    assert calls == [(2 * 4 + 1,)]
    y.backward(g)
    assert calls == [(2 * 4 + 1,)] * 2
    torch.testing.assert_close(y, y_local, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_var, local.running_var, rtol=0, atol=1e-7)
