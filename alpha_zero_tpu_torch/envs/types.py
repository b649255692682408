"""Batched game state shared by the engine and the search.

A game batch is a dataclass of tensors that all share a leading batch
dimension — the ``jax.vmap`` batch of the JAX package written out. Fields,
shapes (after the batch dim) and dtypes are those of
``alpha_zero_tpu.envs.types.GameState``, so states convert to and from the
JAX package's through numpy (``from_numpy`` / ``to_numpy``).

Colors are +1 (black) / -1 (white) / 0 (empty).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict

import numpy as np
import torch

BLACK = 1
WHITE = -1
EMPTY = 0

# Special actions. Flat board moves are [0, N*N); N*N is pass;
# RESIGN mirrors the reference's resign_move == -1.
RESIGN = -1


class TensorStruct:
    """Mixin for dataclasses whose fields are tensors (or nested structs)."""

    # field name -> TensorStruct class, for nested fields.
    _nested: ClassVar[Dict[str, type]] = {}

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Applies ``fn`` to every tensor leaf."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.map(fn) if isinstance(v, TensorStruct) else fn(v)
        return type(self)(**out)

    def map2(self, other, fn):
        """Applies ``fn(a, b)`` leafwise over two structs of the same type."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            out[f.name] = a.map2(b, fn) if isinstance(a, TensorStruct) else fn(a, b)
        return type(self)(**out)

    @classmethod
    def from_numpy(cls, src, device="cpu"):
        """Builds the struct from any object (or dict) with the same field
        names whose leaves convert with ``np.asarray`` — e.g. a JAX pytree
        of the same dataclass."""
        get = src.__getitem__ if isinstance(src, dict) else (
            lambda name: getattr(src, name))
        out = {}
        for f in dataclasses.fields(cls):
            v = get(f.name)
            if f.name in cls._nested:
                out[f.name] = cls._nested[f.name].from_numpy(v, device)
            else:
                out[f.name] = torch.from_numpy(np.array(v)).to(device)
        return cls(**out)

    def to_numpy(self) -> dict:
        """Nested dict of numpy arrays, one per field."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (v.to_numpy() if isinstance(v, TensorStruct)
                           else v.detach().cpu().numpy())
        return out


@dataclasses.dataclass
class GameState(TensorStruct):
    """A batch of games; every field has a leading batch dim [B, ...].

    ``history[:, 0]`` is always the board after the most recent move.
    """

    board: torch.Tensor        # int8[B, N, N]; +1 black, -1 white, 0 empty
    history: torch.Tensor      # int8[B, num_stack, N, N]; [:, 0] == board
    to_play: torch.Tensor      # int8[B]; +1 or -1
    step_count: torch.Tensor   # int32[B]; moves played so far
    done: torch.Tensor         # bool[B]
    winner: torch.Tensor       # int8[B]; +1 / -1 / 0 (none or draw)
    last_move: torch.Tensor    # int32[B]; flat action, -1 resign, -2 none yet
    last_reward: torch.Tensor  # float32[B]; reward of the last step, from the
    #                            mover's perspective
    ko: torch.Tensor           # int32[B]; flat index of the ko point, -1 none
    pass_streak: torch.Tensor  # int32[B]; consecutive passes
    num_passes: torch.Tensor   # int32[B]; total passes
    captures: torch.Tensor     # int32[B, 2]; (black, white) capture counts
    resigned: torch.Tensor     # bool[B]
    final_score: torch.Tensor  # float32[B]; black-perspective score with komi,
    #                            0 until the game completes
    # Cached position analysis, f32 exact small integers / 0-1 flags.
    labels: torch.Tensor       # f32[B, N, N] group labels (N*N = empty)
    group_libs: torch.Tensor   # f32[B, N*N+1] liberty count per group root
    legal: torch.Tensor        # f32[B, num_actions] legal-move mask
