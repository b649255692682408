"""K5, the eval-mode norm kernel (``ops/norm_kernels.py:norm_act``), on the
card: bit-equality with the plain eval chain and device time against the
byte bound, at the shapes the self-play nets run; then the nets themselves.

    python3 -m alpha_zero_tpu_torch.tools.norm_bench [--reps 50] [--no-nets]

For each case of ``CASES`` and each of its variants: K5 against the plain
chain (``norm_act_plain``) on the same input laid out NCHW, as the nets ran
it before K5, and NHWC, every output bit-equal; then the device ms a call of
K5 and of the plain chain on NCHW memory from CUDA-graph replays, beside the
least time the bytes allow at 3.35 TB/s (each input read once, each output
written once). Then, unless ``--no-nets``, the go9, go19_jumbo and
go19_b18c384nbt bf16 eval nets at B=1 and at their self-play batch: the
NHWC net with K5 against the same weights laid out NCHW with the plain
norms (``nchw_twin``), fed the engine's NCHW planes: outputs bit-equal or
the largest gap beside the largest logit, and, given a float32 reference
(``net_cases``), each path's gap to it; ms a forward back to back (the host's dispatch included, as a search sees
it), K5 launches a forward, and the device kernels of one forward, cuDNN's
layout transposes among them. One line a case, then a JSON line. Exits 1
on a mismatch of the kernel.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Callable, Dict, List, Optional

import torch

from alpha_zero_tpu_torch.ops import norm_kernels as nk
from alpha_zero_tpu_torch.utils.device import (HBM_BYTES_PER_S, card_line, device_kernels,
                                               graph_ms, time_ms)

VARIANTS = {"a": nk.NORM_RELU, "b": nk.NORM_ADD_RELU, "c": nk.ADD_NORM_RELU}

# (name, batch, board side, channels, variants): the widths each net
# normalizes at. go19_b18c384nbt: the trunk (384), the mid channels (192),
# the pooling block's narrowed mid (128) and its pooled channels (64).
CASES = [
    ("go9", 4096, 9, 128, "ab"),
    ("go19_jumbo", 512, 19, 256, "ab"),
    ("nbt_trunk", 512, 19, 384, "ac"),
    ("nbt_mid", 512, 19, 192, "ac"),
    ("nbt_pool_mid", 512, 19, 128, "a"),
    ("nbt_gpool", 512, 19, 64, "a"),
    ("go9", 1, 9, 128, "ab"),
    ("go19_jumbo", 1, 19, 256, "ab"),
    ("nbt_trunk", 1, 19, 384, "ac"),
    ("nbt_mid", 1, 19, 192, "ac"),
]

NETS = [("go9", 4096), ("go19_jumbo", 512), ("go19_b18c384nbt", 512),
        ("go9", 1), ("go19_jumbo", 1), ("go19_b18c384nbt", 1)]


def make_bn(c: int, device, seed: int = 0) -> torch.nn.BatchNorm2d:
    """An eval-mode BatchNorm of ``c`` channels with float32 statistics
    drawn from ``seed``: scales of either sign, variances from 0.05 to 3."""
    gen = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.copy_((torch.rand(c, generator=gen) * 3.0 - 1.5))
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_var.copy_(torch.rand(c, generator=gen) * 2.95 + 0.05)
    return bn.to(device)


def make_inputs(batch: int, side: int, c: int, device, seed: int = 0):
    """A conv-output-like bf16 ``x`` and a residual ``res`` (half of it
    ReLU'd, as a ResNet block's input is), both NHWC in memory, with exact
    zeros and values equal to the running mean among them."""
    gen = torch.Generator().manual_seed(seed + 1)
    shape = (batch, side, side, c)
    x = torch.randn(shape, generator=gen) * 1.5
    x.view(-1)[::97] = 0.0
    res = torch.randn(shape, generator=gen)
    res[: batch // 2 + 1] = res[: batch // 2 + 1].clamp_min(0.0)

    def nhwc(t):
        return t.to(torch.bfloat16).to(device).permute(0, 3, 1, 2)

    return nhwc(x), nhwc(res)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def check_variant(mode: int, x: torch.Tensor, res: torch.Tensor, bn) -> Dict[str, int]:
    """Elements of K5's outputs whose bits differ from the plain chain's on
    NCHW memory and on NHWC memory (both outputs for ``ADD_NORM_RELU``)."""
    r = None if mode == nk.NORM_RELU else res
    s, out = nk.norm_act(mode, x, bn, r)
    bad = {}
    for layout, fmt in (("nchw", torch.contiguous_format), ("nhwc", torch.channels_last)):
        ps, pout = nk.norm_act_plain(mode, x.contiguous(memory_format=fmt), bn,
                                     None if r is None else r.contiguous(memory_format=fmt))
        n = int((bits(out) != bits(pout)).sum())
        if s is not None:
            n += int((bits(s) != bits(ps)).sum())
        bad[layout] = n
    return bad


def kernel_cases(reps: int, device) -> List[dict]:
    out = []
    for name, batch, side, c, variants in CASES:
        x, res = make_inputs(batch, side, c, device, seed=c + batch)
        bn = make_bn(c, device, seed=c)
        act_bytes = x.numel() * x.element_size()
        x_nchw, res_nchw = x.contiguous(), res.contiguous()
        for v in variants:
            mode = VARIANTS[v]
            r = None if mode == nk.NORM_RELU else res
            bad = check_variant(mode, x, res, bn)
            moved = {"a": 2, "b": 3, "c": 4}[v] * act_bytes
            line = {
                "case": f"{name}_b{batch}", "variant": v, "channels": c, "rows": x.numel() // c,
                "mismatches": bad,
                "ms": graph_ms(lambda: nk.norm_act(mode, x, bn, r), reps),
                "plain_ms": graph_ms(lambda: nk.norm_act_plain(
                    mode, x_nchw, bn, None if r is None else res_nchw), reps),
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            }
            line["roofline_pct"] = 100.0 * line["bound_ms"] / line["ms"]
            print(f"K5 {line['case']} C={c} ({v}): mismatches {bad}; {line['ms'] * 1e3:.2f} us "
                  f"(bound {line['bound_ms'] * 1e3:.2f} us, {line['roofline_pct']:.1f}%), plain "
                  f"NCHW chain {line['plain_ms'] * 1e3:.2f} us", flush=True)
            out.append(line)
    return out


def nchw_twin(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``net`` with its weights laid out NCHW (a 1x1 conv's too,
    whose NHWC strides ``contiguous()`` would keep) and its norms marked
    ``plain_on_card``: the path before K5, plain norms and cuDNN's layout
    transposes."""
    from alpha_zero_tpu_torch.models.resnet import BatchNorm

    old = copy.deepcopy(net)
    for p in old.parameters():
        p.data = p.data.clone(memory_format=torch.contiguous_format)
    for m in old.modules():
        if isinstance(m, BatchNorm):
            m.plain_on_card = True
    return old


def _gaps(out, ref_logits, ref_values) -> Dict[str, float]:
    """``policy_tv`` and ``value_mae`` of a net's outputs against float32
    reference logits and values, as the benchmark's comparison reads them."""
    prior = torch.softmax(out.pi_logits.float(), -1)
    tv = 0.5 * (prior - torch.softmax(ref_logits.float(), -1)).abs().sum(-1).mean()
    return {"policy_tv": float(tv), "value_mae": float((out.value - ref_values).abs().mean())}


def net_cases(reps: int, device, reference: Optional[Callable] = None) -> List[dict]:
    """The nets of ``NETS``, NHWC with K5 against ``nchw_twin``. With a
    ``reference(name, batch, device)`` that gives ``(weights, obs,
    logits, values)`` (a float32 reference's weights, boards and outputs
    on them), the nets load those weights and run those boards, and each
    path's ``policy_tv`` and ``value_mae`` against the reference are
    reported; without it, random weights of seed 0 with running statistics
    drawn from seed 7 run random planes laid out as the engine's."""
    from alpha_zero_tpu_torch import config as config_lib
    from alpha_zero_tpu_torch.models.resnet import build_network

    out = []
    for name, batch in NETS:
        cfg = config_lib.get_config(name)
        net = build_network(cfg.env, cfg.network, device=device, seed=0)
        gen = torch.Generator().manual_seed(7)
        ref = None
        if reference is not None:
            weights, obs, *ref = reference(name, batch, device)
            missing, unexpected = net.load_state_dict(weights, strict=False)
            if unexpected or not all(k.endswith("num_batches_tracked") for k in missing):
                raise ValueError(f"{name}: reference weights do not fit the net: missing "
                                 f"{missing}, unexpected {unexpected}")
        else:
            with torch.no_grad():
                for m in net.modules():
                    if isinstance(m, torch.nn.BatchNorm2d):
                        c = m.num_features
                        m.running_mean.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
                        m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            n, planes = cfg.env.board_size, cfg.env.num_planes
            # The engine's planes: an NHWC view of NCHW memory.
            obs = (torch.rand((batch, planes, n, n), generator=gen) < 0.3).to(torch.int8)
            obs = obs.to(device).permute(0, 2, 3, 1)
        old = nchw_twin(net)
        with torch.no_grad():
            before = nk.norm_act.launches
            new_out = net(obs)
            launches = nk.norm_act.launches - before
            old_out = old(obs)
            gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(new_out, old_out)]
            scale = float(old_out.pi_logits.abs().max())
            equal = all(torch.equal(a, b) for a, b in zip(new_out, old_out))
            ms = time_ms(lambda: net(obs), reps)
            old_ms = time_ms(lambda: old(obs), reps)
            kernels = device_kernels(lambda: net(obs), 2)
            old_kernels = device_kernels(lambda: old(obs), 2)

        def transposes(ks):
            return sum(c for k, (c, _) in ks.items() if "nchwToNhwc" in k or "nhwcToNchw" in k)

        def top(ks):
            return sorted(((k[:90], c, c * t) for k, (c, t) in ks.items()),
                          key=lambda e: -e[2])[:8]

        line = {"net": name, "batch": batch, "bit_equal": equal, "max_gap": gaps,
                "max_logit": scale, "k5_launches": launches, "ms": ms, "nchw_ms": old_ms,
                "transposes": transposes(kernels), "nchw_transposes": transposes(old_kernels),
                "kernels": top(kernels), "nchw_kernels": top(old_kernels)}
        if ref is not None:
            line["against_reference"] = {"nhwc": _gaps(new_out, *ref),
                                         "nchw": _gaps(old_out, *ref)}
        print(f"net {name} B={batch}: NHWC + K5 {ms:.3f} ms a forward, NCHW plain {old_ms:.3f} "
              f"ms; outputs bit-equal {equal} (max gap logits, value {gaps}; largest logit "
              f"{scale:.4g}); against the float32 reference {line.get('against_reference')}; "
              f"{launches} K5 launches; cuDNN transposes a forward {line['transposes']} (NCHW "
              f"{line['nchw_transposes']})", flush=True)
        for layout in ("kernels", "nchw_kernels"):
            for k, c, t in line[layout]:
                print(f"    {layout[:-8] or 'nhwc'} {c:5.1f} x {k}: {t:.3f} ms a forward",
                      flush=True)
        out.append(line)
        del net, old
        torch.cuda.empty_cache()
    return out


def run(reps: int = 50, nets: bool = True, reference: Optional[Callable] = None) -> dict:
    """The kernel cases, then, with ``nets``, the net cases (``reference``
    as ``net_cases`` takes it)."""
    device = torch.device("cuda")
    result = {"card": card_line(), "kernel": kernel_cases(reps, device)}
    if nets:
        result["nets"] = net_cases(max(reps // 5, 5), device, reference)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--no-nets", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("norm_bench: CUDA is not available")
    result = run(args.reps, not args.no_nets)
    print(result["card"])
    print(json.dumps(result))
    if any(sum(line["mismatches"].values()) for line in result["kernel"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
