"""Dihedral-symmetry data augmentation of training batches.

The port of ``alpha_zero_tpu.ops.symmetry``: one board transform per batch,
applied to the NHWC states and the flat policies, with the pass-move
probability kept as the last policy element. The JAX package draws the
transform inside its jitted step; here the pick is a host-side draw
(``random_transform_id``) and the transform a function of that id, so tests
can feed in the id JAX's ``rng`` gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Transform ids. 0 is identity; 1-5 match the reference's choice set; 6-7
# complete the dihedral group D4.
IDENTITY, H_FLIP, V_FLIP, ROT90, ROT180, ROT270, TRANSPOSE, ANTI_TRANSPOSE = range(8)
NUM_TRANSFORMS = 8
REFERENCE_TRANSFORMS = (H_FLIP, V_FLIP, ROT90, ROT180, ROT270)


def _spatial(x: torch.Tensor, tid: int) -> torch.Tensor:
    """Applies transform ``tid`` over dims (1, 2) of [B, N, N, ...]."""
    if tid == IDENTITY:
        return x
    if tid == H_FLIP:
        return torch.flip(x, dims=(2,))
    if tid == V_FLIP:
        return torch.flip(x, dims=(1,))
    if tid in (ROT90, ROT180, ROT270):
        return torch.rot90(x, tid - ROT90 + 1, dims=(1, 2))
    if tid == TRANSPOSE:
        return x.transpose(1, 2)
    if tid == ANTI_TRANSPOSE:
        return torch.flip(x.transpose(1, 2), dims=(1, 2))
    raise ValueError(f"bad transform id {tid}")


def apply_transform(states: torch.Tensor, pi: torch.Tensor,
                    tid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Applies transform ``tid`` to NHWC ``states [B, N, N, C]`` and flat
    policies ``pi [B, N*N (+1 pass)]``; both come back contiguous (the
    convolutions then see the layout of an untransformed batch)."""
    b, n = states.shape[0], states.shape[1]
    has_pass = pi.shape[-1] == n * n + 1
    board_pi = (pi[:, :-1] if has_pass else pi).reshape(b, n, n)
    board_t = _spatial(board_pi, tid).reshape(b, n * n)
    if has_pass:
        board_t = torch.cat([board_t, pi[:, -1:]], dim=-1)
    return _spatial(states, tid).contiguous(), board_t


def random_transform_id(generator: Optional[torch.Generator]) -> int:
    """The reference's distribution: identity with p=0.5, else uniform over
    the 5 reference transforms. Drawn on the host from ``generator``."""
    do, pick = torch.rand(2, generator=generator).tolist()
    if do < 0.5:
        return IDENTITY
    return REFERENCE_TRANSFORMS[min(int(pick * len(REFERENCE_TRANSFORMS)),
                                    len(REFERENCE_TRANSFORMS) - 1)]
