"""AlphaZero policy/value ResNet as a PyTorch module.

The port of ``alpha_zero_tpu.models.resnet.AlphaZeroNet``: conv stem (3x3,
padding 1; padding 3 for Gomoku) -> K residual blocks (Conv3x3-BN-ReLU x2 +
skip) -> policy head (1x1 conv to 2ch -> BN -> ReLU -> FC) and value head
(1x1 conv to 1ch -> BN -> ReLU -> FC -> ReLU -> FC(1) -> tanh).

The public call takes the JAX package's layout — NHWC int8 planes — and
permutes to NCHW inside. The heads flatten in HWC order, as the Flax net
does, so Flax Dense kernels load without permuting (``params_from_flax``).
A bf16 net on the card with no model axis keeps its conv weights, and so
its activations, in NHWC memory (``torch.channels_last``;
``to_inference_dtype``), and in eval mode every norm whose width is a
multiple of 8 runs with its ReLU and residual add as one CUDA kernel, K5
(``norm_relu``, ``norm_add_relu``, ``add_norm_relu``;
``ops/norm_kernels.py``), bit-equal to the plain ops it replaces.
Train-mode and float32 nets, nets with the model axis (whose weights stay
NCHW) and the CPU run the plain ops as before.
Inference in bf16 mirrors Flax ``dtype=bfloat16``: the convolutions and
dense layers hold bf16 parameters, every BatchNorm keeps its scale, bias
and running statistics in float32 and normalizes in float32
(``to_inference_dtype``), logits are cast to f32 and tanh of the value is
taken in f32.
Training keeps float32 parameters and computes in the config's dtype under
``torch.autocast`` (``training/learner.py``); in train mode the BatchNorm
layers are Flax's (``BatchNorm``).

The model axis (``parallel.mdl > 1``, a net built with a ``mesh``): every
conv and dense layer whose output width ``mdl`` divides is column-parallel
(``ColumnParallelConv2d``, ``ColumnParallelLinear``): the rank holds its
slice of the output channels (``parallel/mesh.py:shard_spec``, JAX's
``_param_spec``), computes them from the whole input and all-gathers them
over its model group. BatchNorm, ReLU, the residual add, the dense biases
and the layers too narrow to split run replicated on the whole tensor, so
every tensor JAX keeps replicated is replicated here with the same
gradient on every rank. ``shard_state_dict`` and ``gather_state_dict``
move between a rank's slices and the whole layout, which every file and
``params_from_flax`` keep.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alpha_zero_tpu_torch.ops import norm_kernels
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.parallel.mesh import Mesh, shard_spec
from alpha_zero_tpu_torch.utils import trace
from alpha_zero_tpu_torch.utils.device import resolve_device

_BN_EPS = 1e-5       # Flax BatchNorm's default epsilon
_BN_MOMENTUM = 0.1   # Flax momentum=0.9 (weight of the old running stat)


class NetworkOutputs(NamedTuple):
    pi_logits: torch.Tensor  # f32[B, num_actions]
    value: torch.Tensor      # f32[B] in [-1, 1], current player's perspective


class ColumnParallelConv2d(nn.Conv2d):
    """A bias-free conv of ``cout`` output channels that holds this rank's
    ``cout / mdl`` of them: it computes them from the whole input (through
    ``copy_to_model``, whose backward sums the input's gradient over the
    model group) and returns all ``cout``, gathered in rank order."""

    def __init__(self, cin: int, cout: int, k: int, pad: int, mdl: int) -> None:
        super().__init__(cin, cout // mdl, k, padding=pad, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = multihost.copy_to_model(x)
        if self.out_channels == 1:
            # A one-channel slice (go9's policy conv at mdl=2) runs as two,
            # the second zero: a one-row product takes another kernel than
            # the whole layer's (a matrix-vector product on the CPU), whose
            # sums round differently. Each row of a wider product is summed
            # alike whatever the others hold.
            weight = torch.cat([self.weight, torch.zeros_like(self.weight)])
            y = self._conv_forward(x, weight, None)[:, :1]
        else:
            y = super().forward(x)
        return multihost.all_gather_channels(y, 1)


class ColumnParallelLinear(nn.Linear):
    """A dense layer of ``fout`` outputs that holds this rank's ``fout / mdl``
    rows of the weight and the whole bias, replicated as JAX keeps it. The
    rank adds its slice of the bias inside its ``F.linear``, as the whole
    layer adds it, so both round alike; the slice goes through
    ``copy_to_model`` too, which gives every rank the whole bias gradient."""

    def __init__(self, fin: int, fout: int, mdl: int) -> None:
        super().__init__(fin, fout // mdl, bias=False)
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo = multihost.mdl_index() * self.out_features
        bias = multihost.copy_to_model(self.bias)[lo:lo + self.out_features]
        y = F.linear(multihost.copy_to_model(x), self.weight, bias)
        return multihost.all_gather_channels(y, -1)


def _conv(cin: int, cout: int, k: int, pad: int, mdl: int = 1) -> nn.Conv2d:
    if shard_spec("weight", (cout, cin, k, k), mdl) is not None:
        return ColumnParallelConv2d(cin, cout, k, pad, mdl)
    return nn.Conv2d(cin, cout, k, padding=pad, bias=False)


def _linear(fin: int, fout: int, mdl: int = 1) -> nn.Linear:
    if shard_spec("weight", (fout, fin), mdl) is not None:
        return ColumnParallelLinear(fin, fout, mdl)
    return nn.Linear(fin, fout)


def batch_moments(xf: torch.Tensor, reduced: Optional[torch.Tensor] = None):
    """Flax's train-mode moments of ``xf`` ``[B, C, H, W]`` per channel: the
    mean and the biased variance E[x^2] - E[x]^2, clipped at 0, over the
    whole batch. With more than one model group, the batch is the global
    one: Σx, Σx² and the count are summed over the data group in one
    ``all_reduce`` that carries autograd (``multihost.all_reduce_sum``), as
    Flax computes them on the dp-sharded array. The ranks of a model group
    hold the same rows, so each sums them once.

    Returns ``(mean, var, sums)``: ``sums`` the data group's ``[Σx, Σx²,
    count]``, None with one model group. Given the ``sums`` of an earlier
    call on the same ``xf`` as ``reduced``, they stand for the collective's
    result, which is not run again; the gradient still crosses the group."""
    if multihost.mesh().dp == 1:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0), None
    c = xf.shape[1]
    sums = multihost.all_reduce_sum(torch.cat([
        xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), xf.new_full((1,), xf.numel() // c)]),
        reduced)
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0), sums


def _normalize_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     reduced: Optional[torch.Tensor] = None):
    """Flax's train-mode BatchNorm of ``x`` in float32 (float64 for a
    float64 input), cast back to ``x``'s dtype: ``(y, mean, var, sums)``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, var, sums = batch_moments(xf, reduced)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype), mean, var, sums


class _TrainBatchNorm(torch.autograd.Function):
    """``_normalize_train`` that keeps only its input (in the input's dtype),
    the weight, the bias and the data group's sums for backward, and runs
    again from them there: the float32 copies of the activation that
    autograd would keep (the cast input for ``x * x`` and ``x - mean`` for
    the scale) live only inside one layer's backward. The same ops on the
    same values under the same autocast state give the gradients autograd
    gives when it keeps them, bit for bit. The running statistics are
    updated once, in forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        y, mean, var, sums = _normalize_train(x, weight, bias, bn.eps)
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean)
        bn.running_var.mul_(1.0 - m).add_(m * var)
        ctx.eps = bn.eps
        ctx.autocast = (x.device.type, torch.is_autocast_enabled(x.device.type),
                        torch.get_autocast_dtype(x.device.type))
        ctx.save_for_backward(x, weight, bias, sums)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, sums = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, weight, bias), ctx.needs_input_grad)]
        device_type, enabled, dtype = ctx.autocast
        with torch.enable_grad(), torch.autocast(device_type, dtype=dtype, enabled=enabled):
            y = _normalize_train(*inputs, ctx.eps, sums)[0]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward is Flax's ``BatchNorm``:
    the batch moments in float32 (float64 for a float64 input), the
    variance biased (E[x^2] - E[x]^2, clipped at 0), over the global batch
    when ranks train together (``batch_moments``), the input normalized
    with them, and the running statistics updated with the same biased
    variance (torch's own forward updates them with the unbiased one;
    ``nn.SyncBatchNorm`` too, so it is no substitute). Backward recomputes
    the layer from its input (``_TrainBatchNorm``), so a bf16 activation is
    kept in bf16 alone.

    Eval mode is torch's ``F.batch_norm``, which takes a bf16 input with
    float32 weights and statistics, normalizes in float32 and returns bf16
    on the CPU and the card alike: Flax's ``BatchNorm(dtype=bfloat16)``,
    which casts only its output (flax ``linen/normalization.py:_normalize``),
    in one launch.

    ``plain_on_card`` is set on the norms of a net with the model axis,
    whose column-parallel convs gather their outputs NCHW, and of the NCHW
    twin a net is compared with (``tools/norm_bench.py:nchw_twin``): they
    run as plain ops on the card in eval mode too, and never as K5."""

    plain_on_card = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _TrainBatchNorm.apply(x, self.weight, self.bias, self)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=_BN_EPS, momentum=_BN_MOMENTUM)


def _fused(bn: BatchNorm, x: torch.Tensor) -> bool:
    """Whether ``bn`` of ``x`` runs as K5. The plain ops run in train mode,
    off the card, for a tensor that is not bf16 (a float32 net), for a
    width that is not a multiple of 8 (the ResNet's heads) and in a net
    with the model axis (``BatchNorm.plain_on_card``); every other norm
    goes to K5, which raises on activations not laid out NHWC. Inside a
    traced call, counts ``net.fused_norms`` or ``net.plain_norms``."""
    fused = (not bn.training and x.is_cuda and x.dtype == torch.bfloat16
             and x.shape[1] % 8 == 0 and not bn.plain_on_card)
    trace.count("net.fused_norms" if fused else "net.plain_norms")
    return fused


def norm_relu(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``relu(bn(x))``."""
    if _fused(bn, x):
        return norm_kernels.norm_act(norm_kernels.NORM_RELU, x, bn)[1]
    return torch.relu(bn(x))


def norm_add_relu(bn: BatchNorm, x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``relu(bn(x) + res)``: the ResNet block's tail."""
    if _fused(bn, x):
        return norm_kernels.norm_act(norm_kernels.NORM_ADD_RELU, x, bn, res)[1]
    return torch.relu(bn(x) + res)


def add_norm_relu(x: torch.Tensor, res: torch.Tensor, bn: BatchNorm,
                  keep_sum: bool = True):
    """``(x + res, relu(bn(x + res)))``: a pre-activation block's residual
    sum and the next norm's activation. Without ``keep_sum`` the sum may
    come back None (K5 does not write it)."""
    if _fused(bn, x):
        return norm_kernels.norm_act(norm_kernels.ADD_NORM_RELU, x, bn, res, keep_sum)
    s = x + res
    return s, torch.relu(bn(s))


def planes_input(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """NHWC board planes ``x`` as ``conv``'s NCHW input in its dtype, laid
    out NHWC in memory when its weight is (``to_inference_dtype``), else in
    the layout they come in."""
    x = x.permute(0, 3, 1, 2)
    w = conv.weight
    if w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous():
        return x.to(w.dtype, memory_format=torch.channels_last)
    return x.to(w.dtype)


def reset_parameters(net: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-uniform weights U(+-sqrt(6 / fan_in)), zero biases, BN at
    identity — the Flax net's initializers — drawn module by module in
    ``net.modules()`` order."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                bound = math.sqrt(6.0 / fan_in)
                w = torch.rand(m.weight.shape, generator=generator) * (2 * bound) - bound
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


class ResNetBlock(nn.Module):
    """Basic residual block."""

    def __init__(self, num_filters: int, mdl: int = 1) -> None:
        super().__init__()
        self.conv1 = _conv(num_filters, num_filters, 3, 1, mdl)
        self.bn1 = _bn(num_filters)
        self.conv2 = _conv(num_filters, num_filters, 3, 1, mdl)
        self.bn2 = _bn(num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = norm_relu(self.bn1, self.conv1(x))
        return norm_add_relu(self.bn2, self.conv2(y), x)


class AlphaZeroNet(nn.Module):
    """Policy + value network over stacked board planes; with ``mdl > 1``
    this rank's part of it (the layers ``shard_spec`` shards are
    column-parallel over the model group)."""

    def __init__(self, num_actions: int, board_size: int, num_planes: int,
                 num_res_blocks: int = 10, num_filters: int = 128,
                 num_fc_units: int = 128, gomoku: bool = False, mdl: int = 1) -> None:
        super().__init__()
        pad = 3 if gomoku else 1  # padding-3 stem fixes Gomoku edge blindness
        side = board_size + 2 * pad - 2  # spatial size after the stem
        self.stem_conv = _conv(num_planes, num_filters, 3, pad, mdl)
        self.stem_bn = _bn(num_filters)
        self.blocks = nn.ModuleList(
            ResNetBlock(num_filters, mdl) for _ in range(num_res_blocks))
        self.policy_conv = _conv(num_filters, 2, 1, 0, mdl)
        self.policy_bn = _bn(2)
        self.policy_fc = _linear(2 * side * side, num_actions, mdl)
        self.value_conv = _conv(num_filters, 1, 1, 0, mdl)
        self.value_bn = _bn(1)
        self.value_fc1 = _linear(side * side, num_fc_units, mdl)
        self.value_fc2 = _linear(num_fc_units, 1, mdl)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.plain_on_card = mdl > 1

    def sharded_names(self) -> set:
        """The ``state_dict`` names this rank holds a slice of: the
        column-parallel layers' weights."""
        return {f"{name}.weight" for name, m in self.named_modules()
                if isinstance(m, (ColumnParallelConv2d, ColumnParallelLinear))}

    @staticmethod
    def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> NetworkOutputs:
        """x: [B, N, N, C] board planes (NHWC, any dtype); with ``mdl > 1``
        the same rows on every rank of the model group, a collective."""
        y = norm_relu(self.stem_bn, self.stem_conv(planes_input(x, self.stem_conv)))
        for block in self.blocks:
            y = block(y)

        p = norm_relu(self.policy_bn, self.policy_conv(y))
        pi_logits = self.policy_fc(self._flatten_hwc(p))

        v = norm_relu(self.value_bn, self.value_conv(y))
        v = torch.relu(self.value_fc1(self._flatten_hwc(v)))
        v = self.value_fc2(v)
        value = torch.tanh(v.float()).squeeze(-1)
        return NetworkOutputs(pi_logits=pi_logits.float(), value=value)


def lays_out_nhwc(net: nn.Module, dtype, device) -> bool:
    """Whether ``to_inference_dtype`` gives ``net`` NHWC conv weights: a
    bf16 net on the card whose norms may run as K5 (not a net with the
    model axis, whose column-parallel convs gather their slices along the
    channel dimension: ``BatchNorm.plain_on_card``). float32 nets stay NCHW
    and take the plain norms."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return (dtype == torch.bfloat16 and torch.device(device).type == "cuda"
            and not any(isinstance(m, BatchNorm) and m.plain_on_card for m in net.modules()))


def to_inference_dtype(net: nn.Module, dtype) -> nn.Module:
    """Casts ``net`` in place to ``dtype`` (a ``torch.dtype`` or its name)
    except its BatchNorm modules, whose weights and buffers stay float32;
    returns ``net``. Every net the port runs in bf16 is made by this. BN's
    tensors are never rounded through ``dtype``: they keep every float32
    bit of the master weights. Where ``lays_out_nhwc``, the conv weights
    are laid out ``torch.channels_last``; a later ``load_state_dict``
    copies into them and keeps that layout."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    first = next(net.parameters(), None)
    nhwc = first is not None and lays_out_nhwc(net, dtype, first.device)
    for module in net.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.float()
            continue
        for param in module.parameters(recurse=False):
            fmt = torch.channels_last if nhwc and param.dim() == 4 else torch.preserve_format
            param.data = param.data.to(dtype, memory_format=fmt)
    return net


def build_network(env_cfg, net_cfg, device="cuda", seed: int = 0,
                  dtype: Optional[str] = None, mesh: Optional[Mesh] = None) -> nn.Module:
    """The net for an (EnvConfig, NetworkConfig) pair: ``AlphaZeroNet`` when
    ``net_cfg.architecture`` is "resnet", KataGo's nested-bottleneck net
    (``models/nbt.py:NestedBottleneckNet``) when it is "nbt". Its random
    weights are drawn from ``seed`` (``reset_parameters``); it is in eval
    mode, with parameters in ``dtype`` (default: the config's inference
    dtype; BatchNorm stays float32). With a ``mesh`` of ``mdl > 1``, this
    rank's part of the ResNet (``multihost.mdl_index``): the slices of the
    whole net drawn from ``seed``. The nbt net has no model axis."""
    dev = resolve_device(device)
    if net_cfg.architecture not in ("resnet", "nbt"):
        raise ValueError(f"network.architecture is {net_cfg.architecture!r}: "
                         "'resnet' or 'nbt'")
    generator = torch.Generator().manual_seed(seed)
    if net_cfg.architecture == "nbt":
        from alpha_zero_tpu_torch.models.nbt import NestedBottleneckNet  # builds on this module

        if mesh is not None and mesh.mdl > 1:
            raise ValueError(f"the nbt net has no model axis: parallel.mdl is {mesh.mdl}, "
                             "and one card holds the whole net; use parallel.mdl=1")
        whole = NestedBottleneckNet.from_config(env_cfg, net_cfg)
        reset_parameters(whole, generator)
    else:
        def net(mdl):
            return AlphaZeroNet(
                num_actions=env_cfg.num_actions,
                board_size=env_cfg.board_size,
                num_planes=env_cfg.num_planes,
                num_res_blocks=net_cfg.num_res_blocks,
                num_filters=net_cfg.num_filters,
                num_fc_units=net_cfg.num_fc_units,
                gomoku=net_cfg.gomoku,
                mdl=mdl,
            )

        whole = net(1)
        reset_parameters(whole, generator)
        if mesh is not None and mesh.mdl > 1:
            part = net(mesh.mdl)
            part.load_state_dict(shard_state_dict(whole.state_dict(), mesh,
                                                  multihost.mdl_index()))
            whole = part
    return to_inference_dtype(whole.to(dev), dtype or net_cfg.inference_dtype).eval()


def shard_state_dict(full: dict, mesh: Mesh, mdl_index: int) -> dict:
    """Rank ``mdl_index``'s slices of a whole-layout ``state_dict`` (or of
    any dict of tensors named as the parameters, such as momentum buffers):
    each tensor ``shard_spec`` shards cut to its part, the rest as is."""
    out = {}
    for name, value in full.items():
        dim = shard_spec(name, value.shape, mesh.mdl)
        if dim is not None:
            width = value.shape[dim] // mesh.mdl
            value = value.narrow(dim, mdl_index * width, width).clone()
        out[name] = value
    return out


def gather_state_dict(net: nn.Module, tensors: Optional[dict] = None) -> dict:
    """The whole layout of ``net``'s ``state_dict`` (or of ``tensors``, a
    dict named as its parameters): every slice gathered over the model
    group. A collective over the model group when ``net`` is sharded."""
    tensors = net.state_dict() if tensors is None else tensors
    sharded = net.sharded_names()
    return {name: multihost.gather_slices(value, 0) if name in sharded else value
            for name, value in tensors.items()}


def _conv_weight(kernel) -> torch.Tensor:
    """Flax conv kernel HWIO -> torch OIHW."""
    return torch.from_numpy(np.array(np.transpose(kernel, (3, 2, 0, 1))))


def _dense(prefix: str, p: dict, out: dict) -> None:
    """Flax Dense ``[in, out]`` kernel -> ``Linear.weight = kernel.T``."""
    out[prefix + ".weight"] = torch.from_numpy(np.array(np.asarray(p["kernel"]).T))
    out[prefix + ".bias"] = torch.from_numpy(np.array(p["bias"]))


def _batchnorm(prefix: str, p: dict, s, out: dict) -> None:
    out[prefix + ".weight"] = torch.from_numpy(np.array(p["scale"]))
    out[prefix + ".bias"] = torch.from_numpy(np.array(p["bias"]))
    if s is None:
        return
    out[prefix + ".running_mean"] = torch.from_numpy(np.array(s["mean"]))
    out[prefix + ".running_var"] = torch.from_numpy(np.array(s["var"]))
    out[prefix + ".num_batches_tracked"] = torch.tensor(0)


def params_from_flax(variables_np: dict) -> dict:
    """The Flax ``{"params", "batch_stats"}`` tree (numpy leaves) of the
    JAX package's ``AlphaZeroNet`` as this module's ``state_dict``. Without
    ``batch_stats`` (e.g. a tree shaped like the params, such as optax's
    momentum trace), the parameters alone, by their ``state_dict`` names."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats")

    def sub(tree, key):
        return None if tree is None else tree[key]

    out: dict = {}
    out["stem_conv.weight"] = _conv_weight(params["Conv_0"]["kernel"])
    _batchnorm("stem_bn", params["BatchNorm_0"], sub(stats, "BatchNorm_0"), out)
    i = 0
    while f"ResNetBlock_{i}" in params:
        bp, bs = params[f"ResNetBlock_{i}"], sub(stats, f"ResNetBlock_{i}")
        out[f"blocks.{i}.conv1.weight"] = _conv_weight(bp["Conv_0"]["kernel"])
        _batchnorm(f"blocks.{i}.bn1", bp["BatchNorm_0"], sub(bs, "BatchNorm_0"), out)
        out[f"blocks.{i}.conv2.weight"] = _conv_weight(bp["Conv_1"]["kernel"])
        _batchnorm(f"blocks.{i}.bn2", bp["BatchNorm_1"], sub(bs, "BatchNorm_1"), out)
        i += 1
    out["policy_conv.weight"] = _conv_weight(params["Conv_1"]["kernel"])
    _batchnorm("policy_bn", params["BatchNorm_1"], sub(stats, "BatchNorm_1"), out)
    _dense("policy_fc", params["Dense_0"], out)
    out["value_conv.weight"] = _conv_weight(params["Conv_2"]["kernel"])
    _batchnorm("value_bn", params["BatchNorm_2"], sub(stats, "BatchNorm_2"), out)
    _dense("value_fc1", params["Dense_1"], out)
    _dense("value_fc2", params["Dense_2"], out)
    return out


def count_params(net: nn.Module) -> int:
    """The number of elements in ``net.parameters()``: what Flax's
    ``params`` collection holds. BatchNorm's running statistics are
    buffers (Flax's ``batch_stats``) and are not counted. For a net built
    with a ``mesh`` of ``mdl > 1``, the count of this rank's slices."""
    return sum(p.numel() for p in net.parameters())
