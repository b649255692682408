"""AlphaZero's policy/value ResNet in plain float32 PyTorch: the
benchmark's net reference, and the weights both sides are given.

The net is michaelnny/alpha_zero's ``AlphaZeroNet``: a 3x3 conv stem
(padding 1; 3 for Gomoku), residual blocks of two 3x3 convs with
BatchNorm and ReLU and a skip, a policy head (1x1 conv to 2 channels, BN,
ReLU, dense to the actions) and a value head (1x1 conv to 1 channel, BN,
ReLU, dense to ``num_fc_units``, ReLU, dense to 1, tanh). Convolutions have
no bias; the heads flatten height, width, channel in that order. BatchNorm
runs in inference form, with running statistics.

The weights are drawn here from the seed, on the device, in one call:
Kaiming-uniform U(+-sqrt(6 / fan_in)) for every conv and dense kernel, zero
biases, BN scale 1 and shift 0. The running statistics of every BN layer
are then set from a calibration batch of random boards drawn from the same
seed, layer by layer, as training leaves them: each layer's mean and biased
variance of its input over batch, height and width. Without that, a net
with identity statistics puts all of its policy on one move (logits with a
spread of 35 at go9), which no trained net does, and every search would
descend one line.

``forward`` computes in float32 with TF32 off. With ``fp8=True`` it is the
control of the comparison, the net one precision below the configured
bf16: every conv and dense layer's input and kernel are rounded to float8
e4m3, each tensor with its own scale (its largest magnitude to 448), and
multiplied with a float32 accumulator (a bf16 product of the rounded
values, which bf16 holds exactly), its output rounded to bf16 and scaled
back; normalisation and activations stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from azbench.reference.nets import _e4m3, _float32_exact, calibration_boards

BN_EPS = 1e-5


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every conv and dense kernel, in drawing order,
    under the names ``models/resnet.py`` gives them. ``cfg`` is a
    configuration file's ``env`` and ``network`` merged."""
    n, f, fc = cfg["board_size"], cfg["num_filters"], cfg["num_fc_units"]
    planes = 2 * cfg["num_stack"] + 1
    side = n + 2 * stem_padding(cfg) - 2
    actions = n * n + 1
    out = [("stem_conv.weight", (f, planes, 3, 3))]
    for i in range(cfg["num_res_blocks"]):
        out += [(f"blocks.{i}.conv1.weight", (f, f, 3, 3)),
                (f"blocks.{i}.conv2.weight", (f, f, 3, 3))]
    out += [("policy_conv.weight", (2, f, 1, 1)),
            ("policy_fc.weight", (actions, 2 * side * side)),
            ("value_conv.weight", (1, f, 1, 1)),
            ("value_fc1.weight", (fc, side * side)),
            ("value_fc2.weight", (1, fc))]
    return out


def stem_padding(cfg: dict) -> int:
    return 3 if cfg.get("gomoku", False) else 1


def bn_layers(cfg: dict) -> List[Tuple[str, int]]:
    """(prefix, channels) of every BN layer, in the order the input meets them."""
    f = cfg["num_filters"]
    out = [("stem_bn", f)]
    for i in range(cfg["num_res_blocks"]):
        out += [(f"blocks.{i}.bn1", f), (f"blocks.{i}.bn2", f)]
    return out + [("policy_bn", 2), ("value_bn", 1)]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 weights of ``seed`` on ``device``, BN statistics not yet
    set (mean 0, variance 1)."""
    shapes = layout(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    w: Dict[str, torch.Tensor] = {}
    for (name, shape), part in zip(shapes, torch.split(flat, sizes)):
        bound = math.sqrt(6.0 / math.prod(shape[1:]))
        w[name] = ((part * 2.0 - 1.0) * bound).reshape(shape)
    for name in ("policy_fc", "value_fc1", "value_fc2"):
        w[f"{name}.bias"] = torch.zeros(w[f"{name}.weight"].shape[0], device=device)
    for prefix, c in bn_layers(cfg):
        w[f"{prefix}.weight"] = torch.ones(c, device=device)
        w[f"{prefix}.bias"] = torch.zeros(c, device=device)
        w[f"{prefix}.running_mean"] = torch.zeros(c, device=device)
        w[f"{prefix}.running_var"] = torch.ones(c, device=device)
    return w


def forward(w: Dict[str, torch.Tensor], cfg: dict, obs: torch.Tensor, fp8: bool = False,
            calibrate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy logits f32 [B, A], value f32 [B]) of int8 observations
    ``obs [B, N, N, C]``. With ``calibrate``, each BN layer's running
    statistics are first set, in ``w``, from its input in this batch."""
    pad = stem_padding(cfg)

    def conv(x, name, padding):
        if not fp8:
            return F.conv2d(x, w[name], padding=padding)
        (qx, sx), (qw, sw) = _e4m3(x), _e4m3(w[name])
        return F.conv2d(qx, qw, padding=padding).float() * (sx * sw)

    def dense(x, name):
        if not fp8:
            return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])
        (qx, sx), (qw, sw) = _e4m3(x), _e4m3(w[f"{name}.weight"])
        return F.linear(qx, qw).float() * (sx * sw) + w[f"{name}.bias"]

    def bn(x, prefix):
        if calibrate:
            w[f"{prefix}.running_mean"] = x.mean(dim=(0, 2, 3))
            w[f"{prefix}.running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
        scale = w[f"{prefix}.weight"] / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + w[f"{prefix}.bias"][:, None, None]

    def flat_hwc(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    with _float32_exact():
        x = obs.permute(0, 3, 1, 2).to(torch.float32)
        y = torch.relu(bn(conv(x, "stem_conv.weight", pad), "stem_bn"))
        for i in range(cfg["num_res_blocks"]):
            z = torch.relu(bn(conv(y, f"blocks.{i}.conv1.weight", 1), f"blocks.{i}.bn1"))
            z = bn(conv(z, f"blocks.{i}.conv2.weight", 1), f"blocks.{i}.bn2")
            y = torch.relu(z + y)
        p = torch.relu(bn(conv(y, "policy_conv.weight", 0), "policy_bn"))
        logits = dense(flat_hwc(p), "policy_fc")
        v = torch.relu(bn(conv(y, "value_conv.weight", 0), "value_bn"))
        v = torch.relu(dense(flat_hwc(v), "value_fc1"))
        value = torch.tanh(dense(v, "value_fc2")).squeeze(-1)
    return logits, value


def calibrated_weights(cfg: dict, seed: int, device, rows: int = 256) -> Dict[str, torch.Tensor]:
    """``make_weights`` with every BN layer's statistics set from
    ``calibration_boards`` of the same seed."""
    w = make_weights(cfg, seed, device)
    with torch.no_grad():
        forward(w, cfg, calibration_boards(cfg, rows, seed ^ 0x5EED, device), calibrate=True)
    return w


def evaluate(w: Dict[str, torch.Tensor], cfg: dict, obs: torch.Tensor, fp8: bool = False,
             block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` in blocks of ``block`` rows, so that the float32
    activations of a wide net fit beside what the run holds."""
    logits, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            lg, v = forward(w, cfg, obs[i:i + block], fp8=fp8)
            logits.append(lg)
            values.append(v)
    return torch.cat(logits), torch.cat(values)


def net_layers(cfg: dict) -> Tuple[list, list]:
    """(convs, denses) of one position's forward pass: convs as (c_in,
    c_out, kernel, in_side, out_side), denses as (fan_in, fan_out). ``cfg``
    is a configuration's ``env`` and ``network`` merged."""
    n, f, fc = cfg["board_size"], cfg["num_filters"], cfg["num_fc_units"]
    side = n + 2 * stem_padding(cfg) - 2
    planes = 2 * cfg["num_stack"] + 1
    convs = [(planes, f, 3, n, side)] + [(f, f, 3, side, side)] * (2 * cfg["num_res_blocks"])
    convs += [(f, 2, 1, side, side), (f, 1, 1, side, side)]
    denses = [(2 * side * side, n * n + 1), (side * side, fc), (fc, 1)]
    return convs, denses
