"""AlphaZero policy/value ResNet as a PyTorch module.

The port of ``alpha_zero_tpu.models.resnet.AlphaZeroNet``: conv stem (3x3,
padding 1; padding 3 for Gomoku) -> K residual blocks (Conv3x3-BN-ReLU x2 +
skip) -> policy head (1x1 conv to 2ch -> BN -> ReLU -> FC) and value head
(1x1 conv to 1ch -> BN -> ReLU -> FC -> ReLU -> FC(1) -> tanh).

The public call takes the JAX package's layout — NHWC int8 planes — and
permutes to NCHW inside. The heads flatten in HWC order, as the Flax net
does, so Flax Dense kernels load without permuting (``params_from_flax``).
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

from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.parallel.mesh import Mesh, shard_spec
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


def batch_moments(xf: torch.Tensor):
    """Flax's train-mode moments of ``xf`` ``[B, C, H, W]`` per channel: the
    mean and the biased variance E[x^2] - E[x]^2, clipped at 0, over the
    whole batch. With more than one model group, the batch is the global
    one: Σx, Σx² and the count are summed over the data group in one
    ``all_reduce`` that carries autograd (``multihost.all_reduce_sum``), as
    Flax computes them on the dp-sharded array. The ranks of a model group
    hold the same rows, so each sums them once."""
    if multihost.mesh().dp == 1:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    c = xf.shape[1]
    sums = multihost.all_reduce_sum(torch.cat([
        xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), xf.new_full((1,), xf.numel() // c)]))
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward is Flax's ``BatchNorm``:
    the batch moments in float32 (float64 for a float64 input), the
    variance biased (E[x^2] - E[x]^2, clipped at 0), over the global batch
    when ranks train together (``batch_moments``), the input normalized
    with them, and the running statistics updated with the same biased
    variance (torch's own forward updates them with the unbiased one;
    ``nn.SyncBatchNorm`` too, so it is no substitute).

    Eval mode is torch's ``F.batch_norm``, which takes a bf16 input with
    float32 weights and statistics, normalizes in float32 and returns bf16
    on the CPU and the card alike: Flax's ``BatchNorm(dtype=bfloat16)``,
    which casts only its output (flax ``linen/normalization.py:_normalize``),
    in one launch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = batch_moments(xf)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=_BN_EPS, momentum=_BN_MOMENTUM)


class ResNetBlock(nn.Module):
    """Basic residual block."""

    def __init__(self, num_filters: int, mdl: int = 1) -> None:
        super().__init__()
        self.conv1 = _conv(num_filters, num_filters, 3, 1, mdl)
        self.bn1 = _bn(num_filters)
        self.conv2 = _conv(num_filters, num_filters, 3, 1, mdl)
        self.bn2 = _bn(num_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)


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

    def sharded_names(self) -> set:
        """The ``state_dict`` names this rank holds a slice of: the
        column-parallel layers' weights."""
        return {f"{name}.weight" for name, m in self.named_modules()
                if isinstance(m, (ColumnParallelConv2d, ColumnParallelLinear))}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-uniform weights U(+-sqrt(6 / fan_in)), zero biases, BN
        at identity — the Flax net's initializers."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    bound = math.sqrt(6.0 / fan_in)
                    w = torch.rand(m.weight.shape, generator=generator) * (2 * bound) - bound
                    m.weight.copy_(w)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()

    @staticmethod
    def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> NetworkOutputs:
        """x: [B, N, N, C] board planes (NHWC, any dtype); with ``mdl > 1``
        the same rows on every rank of the model group, a collective."""
        dtype = self.stem_conv.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)
        y = torch.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.blocks:
            y = block(y)

        p = torch.relu(self.policy_bn(self.policy_conv(y)))
        pi_logits = self.policy_fc(self._flatten_hwc(p))

        v = torch.relu(self.value_bn(self.value_conv(y)))
        v = torch.relu(self.value_fc1(self._flatten_hwc(v)))
        v = self.value_fc2(v)
        value = torch.tanh(v.float()).squeeze(-1)
        return NetworkOutputs(pi_logits=pi_logits.float(), value=value)


def to_inference_dtype(net: nn.Module, dtype) -> nn.Module:
    """Casts ``net`` in place to ``dtype`` (a ``torch.dtype`` or its name)
    except its BatchNorm modules, whose weights and buffers stay float32;
    returns ``net``. Every net the port runs in bf16 is made by this. BN's
    tensors are never rounded through ``dtype``: they keep every float32
    bit of the master weights."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    for module in net.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.float()
            continue
        for param in module.parameters(recurse=False):
            param.data = param.data.to(dtype)
    return net


def build_network(env_cfg, net_cfg, device="cuda", seed: int = 0,
                  dtype: Optional[str] = None, mesh: Optional[Mesh] = None) -> AlphaZeroNet:
    """The net for an (EnvConfig, NetworkConfig) pair, with random weights
    drawn from ``seed``, in eval mode, with parameters in ``dtype`` (default:
    the config's inference dtype; BatchNorm stays float32). With a ``mesh``
    of ``mdl > 1``, this rank's part of it (``multihost.mdl_index``): the
    slices of the whole net drawn from ``seed``."""
    dev = resolve_device(device)

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
    whole.reset_parameters(torch.Generator().manual_seed(seed))
    if mesh is not None and mesh.mdl > 1:
        part = net(mesh.mdl)
        part.load_state_dict(shard_state_dict(whole.state_dict(), mesh, multihost.mdl_index()))
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


def gather_state_dict(net: AlphaZeroNet, tensors: Optional[dict] = None) -> dict:
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
