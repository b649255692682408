"""KataGo's nested-bottleneck policy/value net (``b18c384nbt``) in plain
float32 PyTorch: the benchmark's net reference for configurations whose
``"net"`` is ``"nbt"``, and the weights both sides are given.

Source: lightvector/KataGo ``python/katago/train/model_pytorch.py`` and
``modelconfigs.py``; the global pooling is arXiv:1902.10565's. With C the
trunk (``num_filters``), M the mid channels, G the pooled channels, act ReLU,
convs without bias and every conv reading act(norm(x)):

- stem: a 5x5 conv from the planes to C, padding 2;
- ``num_res_blocks`` blocks, x -> x + conv1x1(M->C)(act(norm(y))), where y
  is conv1x1(C->M)(act(norm(x))) through two inner blocks y -> y + r; a
  plain inner block is r = conv3x3(act(norm(conv3x3(act(norm(y)))))); the
  first inner block of each block in ``nbt_gpool_blocks`` (1-based) is
  a = act(norm(y)); g = act(norm(conv3x3(M->G)(a)));
  h = conv3x3(M->M-G)(a) + dense(3G->M-G)(gpool(g)); r = conv3x3(M-G->M)(act(norm(h)));
- trunk end act(norm(x));
- policy: p = conv1x1(C->P)(x); q = gpool(act(norm(conv1x1(C->G1)(x))));
  board logits conv1x1(P->1)(act(norm(p + dense(3G1->P)(q)))) row-major,
  then the pass logit dense(P->1)(act(dense(3G1->P)(q)));
- value: v = act(norm(conv1x1(C->V1)(x))); tanh(dense(V2->1)(act(dense(3V1->V2)(vpool(v))))).

gpool(t) = [mean, mean * (N - 14) / 10, max] over the N x N board, vpool(t)
= [mean, mean * (N - 14) / 10, mean * ((N - 14)^2 / 100 - 0.1)]: KataGo's
masked pooling on a full board, where its mask is all ones. The departures
from KataGo (the port's input planes and BatchNorm, one policy channel and a
tanh value, biases on the dense layers) are the configuration file's
``assumed``.

The weights are drawn as ``resnet.py`` draws them: Kaiming-uniform
U(+-sqrt(6 / fan_in)) for every conv and dense kernel from one flat draw on
the device, zero biases, norm scale 1 and shift 0, then every norm's running
statistics set from a calibration batch of the same seed, layer by layer.
One departure: the last conv of every residual branch, the outer blocks'
``conv_out`` and the inner blocks' ``conv2``, is drawn at
``branch_scale`` = 1 / sqrt(``num_res_blocks``) of that bound, as
fixup-style initialisation scales residual branches (the configuration
lists it under ``assumed``). Drawn at full scale, the 18 blocks' branches,
each brought to unit size by its calibrated norm, make a net whose bf16
rounding alone moved its policy from float32 by a total variation of up to
0.14 on an H100, too close to the fp8 control for the comparison to tell
them apart.

``forward`` computes in float32 with TF32 off; with ``fp8=True``, the
comparison's control, every conv and dense layer (the pooling ones too)
multiplies e4m3-rounded inputs and kernels, as ``resnet.py`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from azbench.reference.nets import _e4m3, _float32_exact, calibration_boards

BN_EPS = 1e-5
DENSE = ("gfc", "pass_fc1", "pass_fc2", "value_fc1", "value_fc2")
BRANCH_ENDS = (".conv_out.weight", ".conv2.weight")


def _widths(cfg: dict):
    return (cfg["num_filters"], cfg["nbt_mid_channels"], cfg["nbt_gpool_channels"],
            cfg["nbt_policy_channels"], cfg["nbt_policy_gpool_channels"],
            cfg["nbt_value_channels"], cfg["num_fc_units"])


def pooling_blocks(cfg: dict) -> set:
    """0-based indices of the blocks whose first inner block pools."""
    return {int(b) - 1 for b in cfg["nbt_gpool_blocks"].split(",") if b.strip()}


def layout(cfg: dict) -> Tuple[List[Tuple[str, Tuple[int, ...]]], List[Tuple[str, int]]]:
    """(kernels, norms): (name, shape) of every conv and dense kernel in
    drawing order, and (prefix, channels) of every norm in the order the
    input meets them, under the names ``models/nbt.py`` gives them."""
    c, m, g, p, g1, v1, fc = _widths(cfg)
    kernels = [("stem_conv.weight", (c, 2 * cfg["num_stack"] + 1, 5, 5))]
    norms = []
    for i in range(cfg["num_res_blocks"]):
        b = f"blocks.{i}"
        kernels.append((f"{b}.conv_in.weight", (m, c, 1, 1)))
        norms.append((f"{b}.bn_in", c))
        for j in range(2):
            q = f"{b}.inner.{j}"
            if j == 0 and i in pooling_blocks(cfg):
                kernels += [(f"{q}.conv1.weight", (m - g, m, 3, 3)),
                            (f"{q}.gconv.weight", (g, m, 3, 3)),
                            (f"{q}.gfc.weight", (m - g, 3 * g)),
                            (f"{q}.conv2.weight", (m, m - g, 3, 3))]
                norms += [(f"{q}.bn1", m), (f"{q}.gbn", g), (f"{q}.bn2", m - g)]
            else:
                kernels += [(f"{q}.conv1.weight", (m, m, 3, 3)),
                            (f"{q}.conv2.weight", (m, m, 3, 3))]
                norms += [(f"{q}.bn1", m), (f"{q}.bn2", m)]
        kernels.append((f"{b}.conv_out.weight", (c, m, 1, 1)))
        norms.append((f"{b}.bn_out", m))
    kernels += [("policy_conv.weight", (p, c, 1, 1)), ("policy_gconv.weight", (g1, c, 1, 1)),
                ("policy_gfc.weight", (p, 3 * g1)), ("policy_out.weight", (1, p, 1, 1)),
                ("pass_fc1.weight", (p, 3 * g1)), ("pass_fc2.weight", (1, p)),
                ("value_conv.weight", (v1, c, 1, 1)), ("value_fc1.weight", (fc, 3 * v1)),
                ("value_fc2.weight", (1, fc))]
    norms += [("trunk_bn", c), ("policy_gbn", g1), ("policy_bn", p), ("value_bn", v1)]
    return kernels, norms


def branch_scale(cfg: dict) -> float:
    """The scale of every residual branch's last conv at initialisation."""
    return 1.0 / math.sqrt(cfg["num_res_blocks"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 weights of ``seed`` on ``device``, norm statistics not
    yet set (mean 0, variance 1)."""
    kernels, norms = layout(cfg)
    sizes = [math.prod(s) for _, s in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    w: Dict[str, torch.Tensor] = {}
    for (name, shape), part in zip(kernels, torch.split(flat, sizes)):
        bound = math.sqrt(6.0 / math.prod(shape[1:]))
        if name.endswith(BRANCH_ENDS):
            bound *= branch_scale(cfg)
        w[name] = ((part * 2.0 - 1.0) * bound).reshape(shape)
        if name.split(".")[-2].endswith(DENSE):
            w[name.replace(".weight", ".bias")] = torch.zeros(shape[0], device=device)
    for prefix, ch in norms:
        w[f"{prefix}.weight"] = torch.ones(ch, device=device)
        w[f"{prefix}.bias"] = torch.zeros(ch, device=device)
        w[f"{prefix}.running_mean"] = torch.zeros(ch, device=device)
        w[f"{prefix}.running_var"] = torch.ones(ch, device=device)
    return w


def forward(w: Dict[str, torch.Tensor], cfg: dict, obs: torch.Tensor, fp8: bool = False,
            calibrate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy logits f32 [B, N*N + 1], value f32 [B]) of int8 observations
    ``obs [B, N, N, C]``. With ``calibrate``, each norm's running statistics
    are first set, in ``w``, from its input in this batch."""
    n = cfg["board_size"]
    s1, s2 = (n - 14.0) / 10.0, (n - 14.0) ** 2 / 100.0 - 0.1
    pooling = pooling_blocks(cfg)

    def conv(x, name):
        k = w[f"{name}.weight"]
        if not fp8:
            return F.conv2d(x, k, padding=k.shape[-1] // 2)
        (qx, sx), (qk, sk) = _e4m3(x), _e4m3(k)
        return F.conv2d(qx, qk, padding=k.shape[-1] // 2).float() * (sx * sk)

    def dense(x, name):
        if not fp8:
            return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])
        (qx, sx), (qk, sk) = _e4m3(x), _e4m3(w[f"{name}.weight"])
        return F.linear(qx, qk).float() * (sx * sk) + w[f"{name}.bias"]

    def norm_act(x, prefix):
        if calibrate:
            w[f"{prefix}.running_mean"] = x.mean(dim=(0, 2, 3))
            w[f"{prefix}.running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
        scale = w[f"{prefix}.weight"] / torch.sqrt(var + BN_EPS)
        return torch.relu((x - mean[:, None, None]) * scale[:, None, None]
                          + w[f"{prefix}.bias"][:, None, None])

    def gpool(t):
        mean = t.mean(dim=(2, 3))
        return torch.cat([mean, s1 * mean, t.amax(dim=(2, 3))], dim=1)

    with _float32_exact():
        x = conv(obs.permute(0, 3, 1, 2).to(torch.float32), "stem_conv")
        for i in range(cfg["num_res_blocks"]):
            b = f"blocks.{i}"
            y = conv(norm_act(x, f"{b}.bn_in"), f"{b}.conv_in")
            for j in range(2):
                q = f"{b}.inner.{j}"
                a = norm_act(y, f"{q}.bn1")
                h = conv(a, f"{q}.conv1")
                if j == 0 and i in pooling:
                    g = norm_act(conv(a, f"{q}.gconv"), f"{q}.gbn")
                    h = h + dense(gpool(g), f"{q}.gfc")[:, :, None, None]
                y = y + conv(norm_act(h, f"{q}.bn2"), f"{q}.conv2")
            x = x + conv(norm_act(y, f"{b}.bn_out"), f"{b}.conv_out")
        x = norm_act(x, "trunk_bn")

        q = gpool(norm_act(conv(x, "policy_gconv"), "policy_gbn"))
        p = conv(x, "policy_conv") + dense(q, "policy_gfc")[:, :, None, None]
        board = conv(norm_act(p, "policy_bn"), "policy_out").reshape(x.shape[0], n * n)
        logits = torch.cat([board, dense(torch.relu(dense(q, "pass_fc1")), "pass_fc2")], dim=1)

        v = norm_act(conv(x, "value_conv"), "value_bn")
        mean = v.mean(dim=(2, 3))
        v = torch.relu(dense(torch.cat([mean, s1 * mean, s2 * mean], dim=1), "value_fc1"))
        value = torch.tanh(dense(v, "value_fc2")).squeeze(-1)
    return logits, value


def calibrated_weights(cfg: dict, seed: int, device, rows: int = 256) -> Dict[str, torch.Tensor]:
    """``make_weights`` with every norm's statistics set from
    ``calibration_boards`` of the same seed."""
    w = make_weights(cfg, seed, device)
    with torch.no_grad():
        forward(w, cfg, calibration_boards(cfg, rows, seed ^ 0x5EED, device), calibrate=True)
    return w


def evaluate(w: Dict[str, torch.Tensor], cfg: dict, obs: torch.Tensor, fp8: bool = False,
             block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` in blocks of ``block`` rows, so that the float32
    activations fit beside what the run holds."""
    logits, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            lg, v = forward(w, cfg, obs[i:i + block], fp8=fp8)
            logits.append(lg)
            values.append(v)
    return torch.cat(logits), torch.cat(values)


def net_layers(cfg: dict) -> Tuple[list, list]:
    """(convs, denses) of one position's forward pass: convs as (c_in,
    c_out, kernel, in_side, out_side), denses as (fan_in, fan_out), every
    one of ``layout``'s kernels (stem, 1x1s, pooling dense layers and heads
    included). Every conv keeps the board's side."""
    n = cfg["board_size"]
    kernels, _ = layout(cfg)
    convs = [(s[1], s[0], s[2], n, n) for _, s in kernels if len(s) == 4]
    denses = [(s[1], s[0]) for _, s in kernels if len(s) == 2]
    return convs, denses
