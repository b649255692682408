"""Eval-mode BatchNorm with its ReLU and residual add as one CUDA kernel (K5).

``norm_act(mode, x, bn, res)`` computes, for a bf16 activation ``x`` and a
BatchNorm module ``bn`` in eval mode (float32 weight, bias and running
statistics):

- ``NORM_RELU``: ``relu(bn(x))``;
- ``NORM_ADD_RELU``: ``relu(bn(x) + res)``, the ResNet block's tail;
- ``ADD_NORM_RELU``: ``s = x + res`` and ``relu(bn(s))``, both returned (the
  sum only with ``keep_sum``): a pre-activation block's residual sum and the
  next block's input activation.

For tensors on the CPU it runs the plain version, ``norm_act_plain``: the
eval chain of ``F.batch_norm``, ``torch.relu`` and the bf16 ``+`` that the
nets ran before. For CUDA tensors it launches the kernel in
``csrc/norm_act.cu`` or raises; the kernel takes activations laid out NHWC
(``torch.channels_last``) with C a multiple of 8 and computes the same bits
as the plain chain on the card. A call on the card is one kernel launch.
``norm_act.launches`` counts the launches; a call made while a CUDA graph
is being captured only records the kernel and is not counted, nor are the
graph's replays.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from alpha_zero_tpu_torch.ops import _build

NORM_RELU, NORM_ADD_RELU, ADD_NORM_RELU = 0, 1, 2
MAX_CHANNELS = 2048  # csrc/norm_act.cu: C / 8 <= 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIBRARY = "norm_act", {
    # mode, x, res, weight, bias, mean, var, eps, rows, C, out, sum_out, device
    "azt_norm_act": [_I] + [_P] * 6 + [ctypes.c_float, ctypes.c_longlong, _I, _P, _P, _I],
}


def norm_act_plain(mode: int, x: torch.Tensor, bn, res: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(sum, out)`` of ``mode`` by plain ops (``sum`` None but for
    ``ADD_NORM_RELU``), BatchNorm in eval mode whatever ``bn.training``."""
    def norm(t):
        return F.batch_norm(t, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)

    if mode == NORM_RELU:
        return None, torch.relu(norm(x))
    if mode == NORM_ADD_RELU:
        return None, torch.relu(norm(x) + res)
    s = x + res
    return s, torch.relu(norm(s))


def _check_inputs(mode: int, x: torch.Tensor, bn, res: Optional[torch.Tensor]) -> None:
    if mode not in (NORM_RELU, NORM_ADD_RELU, ADD_NORM_RELU):
        raise ValueError(f"mode must be NORM_RELU, NORM_ADD_RELU or ADD_NORM_RELU, got {mode}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if c % 8 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 8 up to {MAX_CHANNELS}; got C={c}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be laid out NHWC (torch.channels_last): a bf16 eval net "
                         "gets that layout from to_inference_dtype on the card")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if (res is None) != (mode == NORM_RELU):
        raise ValueError("res is given exactly when the mode adds a residual")
    if res is not None:
        if res.shape != x.shape or res.dtype != x.dtype or res.device != x.device:
            raise ValueError(f"res must be {x.dtype} {tuple(x.shape)} on {x.device}, got "
                             f"{res.dtype} {tuple(res.shape)} on {res.device}")
        if not res.is_contiguous(memory_format=torch.channels_last) or res.data_ptr() % 16:
            raise ValueError("res must be NHWC (torch.channels_last) on a 16-byte boundary")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t is None or t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"bn.{name} must be a contiguous float32 [{c}] on {x.device}")


def norm_act(mode: int, x: torch.Tensor, bn, res: Optional[torch.Tensor] = None,
             keep_sum: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(sum, out)`` of ``mode`` (see the module's docstring) for ``x``
    ``[B, C, H, W]`` and the BatchNorm module ``bn``, normalizing with its
    running statistics. ``sum`` is None but for ``ADD_NORM_RELU`` with
    ``keep_sum``. On the card ``x`` (and ``res``) are bf16 NHWC with C a
    multiple of 8; the outputs are NHWC."""
    if x.device.type == "cpu":
        s, out = norm_act_plain(mode, x, bn, res)
        return (s if keep_sum else None), out
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no norm kernel for device {dev}")
    _check_inputs(mode, x, bn, res)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    s = (torch.empty_like(x, memory_format=torch.channels_last)
         if mode == ADD_NORM_RELU and keep_sum else None)
    if _build.launch(
            _LIBRARY, "azt_norm_act", dev,
            mode, x.data_ptr(), None if res is None else res.data_ptr(), bn.weight.data_ptr(),
            bn.bias.data_ptr(), bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.eps,
            x.numel() // x.shape[1], x.shape[1], out.data_ptr(),
            None if s is None else s.data_ptr(), dev.index) and x.numel():
        norm_act.launches += 1
    return s, out


norm_act.launches = 0
