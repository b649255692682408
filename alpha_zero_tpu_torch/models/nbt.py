"""KataGo's nested-bottleneck policy/value net (``b18c384nbt``) as a PyTorch module.

Source: lightvector/KataGo ``python/katago/train/model_pytorch.py``
(``NestedBottleneckResBlock``, ``ResBlock`` with global pooling,
``PolicyHead``, ``ValueHead``) and ``modelconfigs.py`` (``b18c384nbt``);
the global pooling is arXiv:1902.10565's. Every conv reads act(norm(x))
(pre-activation); act is ReLU, convs have no bias, norms are
``resnet.BatchNorm``. With C the trunk (``num_filters``), M the mid
channels and G the pooled channels:

- stem: a 5x5 conv from the planes to C, padding 2;
- block (x -> x + out): out = conv1x1(C->M)(act(norm(x))), then two inner
  blocks at M (y -> y + r), then out = conv1x1(M->C)(act(norm(out)));
  a plain inner block is r = conv3x3(act(norm(conv3x3(act(norm(y)))))),
  and the first inner block of each pooling block is
  a = act(norm(y)); g = act(norm(conv3x3(M->G)(a)));
  h = conv3x3(M->M-G)(a) + dense(3G->M-G)(gpool(g)); r = conv3x3(M-G->M)(act(norm(h)));
- trunk end: act(norm(x));
- policy head: p = conv1x1(C->P)(x); g = act(norm(conv1x1(C->G1)(x)));
  q = gpool(g); p = act(norm(p + dense(3G1->P)(q))); the board logits are
  conv1x1(P->1)(p) in row-major order, the pass logit
  dense(P->1)(act(dense(3G1->P)(q))), last;
- value head: v = act(norm(conv1x1(C->V1)(x))); value =
  tanh(dense(V2->1)(act(dense(3V1->V2)(vpool(v))))), the tanh in float32.

``gpool(t)`` is [mean, mean * (N - 14) / 10, max] over the N x N board and
``vpool(t)`` [mean, mean * (N - 14) / 10, mean * ((N - 14)^2 / 100 - 0.1)]:
KataGo's, whose square root of the masked area is N on a full board, where
its masks are all ones and its masked pooling is plain pooling.

Departures from KataGo: the input is the port's stacked AlphaZero planes,
not KataGo's spatial and global features; the norm is Flax's BatchNorm, not
KataGo's own (at inference both are a per-channel scale and bias); one
policy channel and one tanh value, without KataGo's other policy channels
and its win/loss/no-result, score and ownership heads; every dense layer
has a bias (drawn zero; before a norm a per-channel constant changes
nothing).

The layout is NCHW as in ``AlphaZeroNet``, and the call takes NHWC planes.
Inference in bf16 and training run as the ResNet's do
(``resnet.to_inference_dtype``, ``training/learner.py``): on the card a bf16
eval net holds its activations in NHWC memory and runs its norms as K5
(``resnet.norm_relu``, ``resnet.add_norm_relu``). So that a residual sum and
the activation of the norm after it come out of one pass, each block maps
its input's activation to its residual branch, and the loops over blocks
(``residual_stack``) add the branches and apply the norms. Inside a traced
call (``utils/trace.py``) the net records the spans ``net.trunk``,
``net.gpool`` (each pooling site) and ``net.heads``, and the counters
``net.positions`` (the call's rows) and ``net.gpool_sites``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from alpha_zero_tpu_torch.models.resnet import (NetworkOutputs, _bn, _conv, _linear,
                                                add_norm_relu, norm_relu, planes_input)
from alpha_zero_tpu_torch.utils import trace


def pool_scales(board_size: int):
    """KataGo's two pooling scales for an N x N board: (N - 14) / 10 and
    (N - 14)^2 / 100 - 0.1 (0.5 and 0.15 on 19x19)."""
    b = board_size - 14.0
    return b / 10.0, b * b / 100.0 - 0.1


def gpool(t: torch.Tensor, scale: float) -> torch.Tensor:
    """[mean, scale * mean, max] of ``t`` [B, C, H, W] over the board: [B, 3C]."""
    mean = t.mean(dim=(2, 3))
    return torch.cat([mean, mean * scale, t.amax(dim=(2, 3))], dim=1)


def vpool(t: torch.Tensor, scale: float, scale2: float) -> torch.Tensor:
    """[mean, scale * mean, scale2 * mean] of ``t`` over the board: [B, 3C]."""
    mean = t.mean(dim=(2, 3))
    return torch.cat([mean, mean * scale, mean * scale2], dim=1)


def residual_stack(y: torch.Tensor, blocks, norms: List[nn.Module]) -> torch.Tensor:
    """``y`` through the pre-activation residual ``blocks``: ``norms[i]`` is
    the norm before block ``i`` and ``norms[-1]`` the one after the last;
    each block maps that norm's activation to its residual branch. Returns
    ``act(norms[-1](...))``. Each residual sum and the activation of the
    norm after it come out of one pass (``resnet.add_norm_relu``); the last
    sum is not kept."""
    a = norm_relu(norms[0], y)
    for block, norm in zip(blocks, norms[1:]):
        y, a = add_norm_relu(y, block(a), norm, keep_sum=norm is not norms[-1])
    return a


class InnerBlock(nn.Module):
    """A pre-activation residual block of two 3x3 convs at ``c`` channels:
    y -> y + conv2(act(bn2(conv1(act(bn1(y))))))."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.bn1 = _bn(c)
        self.conv1 = _conv(c, c, 3, 1)
        self.bn2 = _bn(c)
        self.conv2 = _conv(c, c, 3, 1)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """The residual branch of ``a`` = act(bn1(y)) (``residual_stack``
        applies ``bn1`` and adds the branch to y)."""
        return self.conv2(norm_relu(self.bn2, self.conv1(a)))


class PoolingInnerBlock(nn.Module):
    """An inner block whose first conv gives ``c - g`` channels and takes a
    per-channel bias pooled over the board from ``g`` more."""

    def __init__(self, c: int, g: int, scale: float) -> None:
        super().__init__()
        self.scale = scale
        self.bn1 = _bn(c)
        self.conv1 = _conv(c, c - g, 3, 1)
        self.gconv = _conv(c, g, 3, 1)
        self.gbn = _bn(g)
        self.gfc = _linear(3 * g, c - g)
        self.bn2 = _bn(c - g)
        self.conv2 = _conv(c - g, c, 3, 1)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """As ``InnerBlock.forward``."""
        h = self.conv1(a)
        with trace.span("net.gpool"):
            trace.count("net.gpool_sites")
            g = norm_relu(self.gbn, self.gconv(a))
            h = h + self.gfc(gpool(g, self.scale))[:, :, None, None]
        return self.conv2(norm_relu(self.bn2, h))


class NestedBottleneckBlock(nn.Module):
    """x -> x + conv1x1(c->trunk)(act(norm(inner blocks(conv1x1(trunk->c)(act(norm(x)))))))."""

    def __init__(self, trunk: int, mid: int, inner: List[nn.Module]) -> None:
        super().__init__()
        self.bn_in = _bn(trunk)
        self.conv_in = _conv(trunk, mid, 1, 0)
        self.inner = nn.ModuleList(inner)
        self.bn_out = _bn(mid)
        self.conv_out = _conv(mid, trunk, 1, 0)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """The residual branch of ``a`` = act(bn_in(x)), as
        ``InnerBlock.forward``."""
        norms = [block.bn1 for block in self.inner] + [self.bn_out]
        return self.conv_out(residual_stack(self.conv_in(a), self.inner, norms))


class NestedBottleneckNet(nn.Module):
    """KataGo's nested-bottleneck net over stacked Go board planes."""

    def __init__(self, num_actions: int, board_size: int, num_planes: int, num_blocks: int,
                 trunk: int, mid: int, gpool_channels: int, gpool_blocks: tuple,
                 policy_channels: int, policy_gpool_channels: int, value_channels: int,
                 num_fc_units: int) -> None:
        super().__init__()
        if num_actions != board_size * board_size + 1:
            raise ValueError(f"the nbt net plays Go: {num_actions} actions on a {board_size}x"
                             f"{board_size} board have no pass move")
        bad = sorted(set(gpool_blocks) - set(range(1, num_blocks + 1)))
        if bad:
            raise ValueError(f"nbt_gpool_blocks {bad} are not among blocks 1..{num_blocks}")
        self.scale, self.value_scale = pool_scales(board_size)
        p, g1, v1 = policy_channels, policy_gpool_channels, value_channels
        self.stem_conv = _conv(num_planes, trunk, 5, 2)
        self.blocks = nn.ModuleList(
            NestedBottleneckBlock(trunk, mid, [
                PoolingInnerBlock(mid, gpool_channels, self.scale) if i + 1 in gpool_blocks
                else InnerBlock(mid), InnerBlock(mid)])
            for i in range(num_blocks))
        self.trunk_bn = _bn(trunk)
        self.policy_conv = _conv(trunk, p, 1, 0)
        self.policy_gconv = _conv(trunk, g1, 1, 0)
        self.policy_gbn = _bn(g1)
        self.policy_gfc = _linear(3 * g1, p)
        self.policy_bn = _bn(p)
        self.policy_out = _conv(p, 1, 1, 0)
        self.pass_fc1 = _linear(3 * g1, p)
        self.pass_fc2 = _linear(p, 1)
        self.value_conv = _conv(trunk, v1, 1, 0)
        self.value_bn = _bn(v1)
        self.value_fc1 = _linear(3 * v1, num_fc_units)
        self.value_fc2 = _linear(num_fc_units, 1)

    @classmethod
    def from_config(cls, env_cfg, net_cfg) -> "NestedBottleneckNet":
        if net_cfg.gomoku:
            raise ValueError("the nbt net plays Go: network.gomoku must be false")
        return cls(num_actions=env_cfg.num_actions, board_size=env_cfg.board_size,
                   num_planes=env_cfg.num_planes, num_blocks=net_cfg.num_res_blocks,
                   trunk=net_cfg.num_filters, mid=net_cfg.nbt_mid_channels,
                   gpool_channels=net_cfg.nbt_gpool_channels,
                   gpool_blocks=parse_blocks(net_cfg.nbt_gpool_blocks),
                   policy_channels=net_cfg.nbt_policy_channels,
                   policy_gpool_channels=net_cfg.nbt_policy_gpool_channels,
                   value_channels=net_cfg.nbt_value_channels,
                   num_fc_units=net_cfg.num_fc_units)

    def sharded_names(self) -> set:
        """The empty set: the net has no model axis (``build_network``)."""
        return set()

    def forward(self, x: torch.Tensor) -> NetworkOutputs:
        """x: [B, N, N, C] board planes (NHWC, any dtype)."""
        trace.count("net.positions", x.shape[0])
        with trace.span("net.trunk"):
            y = self.stem_conv(planes_input(x, self.stem_conv))
            norms = [block.bn_in for block in self.blocks] + [self.trunk_bn]
            y = residual_stack(y, self.blocks, norms)

        with trace.span("net.heads"):
            p = self.policy_conv(y)
            with trace.span("net.gpool"):
                trace.count("net.gpool_sites")
                q = gpool(norm_relu(self.policy_gbn, self.policy_gconv(y)), self.scale)
                p = p + self.policy_gfc(q)[:, :, None, None]
                pass_logit = self.pass_fc2(torch.relu(self.pass_fc1(q)))
            board = self.policy_out(norm_relu(self.policy_bn, p)).flatten(1)
            pi_logits = torch.cat([board, pass_logit], dim=1)

            v = norm_relu(self.value_bn, self.value_conv(y))
            with trace.span("net.gpool"):
                trace.count("net.gpool_sites")
                v = vpool(v, self.scale, self.value_scale)
                v = self.value_fc2(torch.relu(self.value_fc1(v)))
            value = torch.tanh(v.float()).squeeze(-1)
        return NetworkOutputs(pi_logits=pi_logits.float(), value=value)


def parse_blocks(text: str) -> tuple:
    """``"3,6,9"`` -> ``(3, 6, 9)``; ``""`` -> ``()``."""
    return tuple(int(b) for b in text.split(",") if b.strip())
