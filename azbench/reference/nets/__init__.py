"""The benchmark's net references, one module a net, in plain float32
PyTorch, and what they share.

A configuration file names its net under ``"net"``; the harness loads
``reference/nets/<net>.py`` (``harness.reference_net``). Such a module
provides:

- ``calibrated_weights(cfg, seed, device, rows=256)``: the float32 weights
  of ``seed``, drawn on ``device``, as a state dict under the port's names,
  with any normalisation statistics set from ``calibration_boards``.
- ``forward(w, cfg, obs, fp8=False, calibrate=False)``: (policy logits f32
  [B, A], value f32 [B]) of int8 observations [B, N, N, C], in float32 with
  TF32 off (``_float32_exact``). With ``fp8=True``, the comparison's
  control: the net one precision below the configured bf16 (``_e4m3``).
- ``evaluate(w, cfg, obs, fp8=False, block=1024)``: ``forward`` in blocks
  of ``block`` rows.
- ``net_layers(cfg) -> (convs, denses)`` of one position's forward pass:
  convs as (c_in, c_out, kernel, in_side, out_side), denses as (fan_in,
  fan_out), from which ``arith`` counts operations and bytes.

``cfg`` is a configuration file's ``env`` and ``network`` merged. The
program's side of the comparison is the net that the port's
``models/resnet.py:build_network`` builds from that ``network``; the
reference imports nothing of the port.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

E4M3_MAX = 448.0


def calibration_boards(cfg: dict, rows: int, seed: int, device) -> torch.Tensor:
    """int8 [rows, N, N, C] observations of random boards: stone density
    uniform in [0, 0.7] a board, older history planes with fewer stones.
    They depend on the game alone, so every net of a game is calibrated on
    the same boards."""
    n, s = cfg["board_size"], cfg["num_stack"]
    gen = torch.Generator(device=device).manual_seed(seed)
    density = torch.rand((rows, 1, 1, 1), generator=gen, device=device) * 0.7
    u = torch.rand((rows, 1, n, n), generator=gen, device=device)
    color = torch.where(torch.rand((rows, 1, n, n), generator=gen, device=device) < 0.5, 1, -1)
    age = torch.arange(s, device=device).reshape(1, s, 1, 1)
    board = torch.where(u < density * (1.0 - 0.05 * age), color, 0)  # [rows, S, N, N]
    to_play = torch.where(torch.rand((rows, 1, 1, 1), generator=gen, device=device) < 0.5, 1, -1)
    planes = torch.stack([board == to_play, board == -to_play], dim=2).reshape(rows, 2 * s, n, n)
    black = (to_play == 1).expand(rows, 1, n, n)
    return torch.cat([planes, black], dim=1).to(torch.int8).permute(0, 2, 3, 1)


@contextlib.contextmanager
def _float32_exact():
    """TF32 off for convolutions and matrix products, restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def _e4m3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` rounded to e4m3 with one scale (its largest magnitude to 448):
    the rounded values, exact in bf16, and the scale."""
    scale = x.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.bfloat16), scale
