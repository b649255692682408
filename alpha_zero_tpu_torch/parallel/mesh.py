"""The rank layout: a ``('dp', 'mdl')`` mesh of processes, which parameters
the model axis shards, each rank's device and the collective backend.

The port of ``alpha_zero_tpu.parallel.mesh``. There are ``dp * mdl`` ranks;
rank ``r`` sits at ``(dp_index, mdl_index) = (r // mdl, r % mdl)``, the
order of JAX's ``devices.reshape(dp, mdl)``. The ``mdl`` consecutive ranks
of one ``dp_index`` form a model group: they play the same games and train
on the same rows, each holding its slice of the output channels of every
parameter ``shard_spec`` shards (JAX's ``_param_spec``). The ``dp`` ranks
of one ``mdl_index`` form a data group, over which gradients and the
BatchNorm moments are reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from alpha_zero_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    dp: int   # model groups, each with its share of the games and the train batch
    mdl: int  # ranks of a model group, each with its slice of the wide layers

    @property
    def world(self) -> int:
        return self.dp * self.mdl

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(dp_index, mdl_index)`` of ``rank``."""
        return divmod(rank, self.mdl)


def make_mesh(world: int, mdl: int = 1) -> Mesh:
    """The mesh of ``world`` ranks with ``mdl`` ranks a model group; raises
    where JAX's ``make_mesh`` raises (``world`` not divisible by ``mdl``)."""
    if world < 1 or mdl < 1:
        raise ValueError(f"a mesh needs at least one rank and mdl >= 1, got {world} "
                         f"ranks and mdl={mdl}")
    if world % mdl:
        raise ValueError(f"{world} ranks not divisible by mdl={mdl}")
    return Mesh(dp=world // mdl, mdl=mdl)


def shard_spec(name: str, shape: Sequence[int], mdl: int) -> Optional[int]:
    """The dimension of the torch parameter ``name`` of ``shape`` (whole
    layout) that the model axis shards, or None when it stays replicated:
    JAX's ``_param_spec``. Flax shards the trailing, output-feature
    dimension of every parameter of 2 or more dimensions when ``mdl``
    divides it; a torch conv (OIHW) or linear (``[out, in]``) weight keeps
    that dimension first. BatchNorm's and the dense layers' 1-D tensors stay
    replicated."""
    del name  # the decision is the shape's, as in JAX
    if mdl <= 1 or len(shape) < 2 or shape[0] % mdl:
        return None
    return 0


def rank_device(device, local_rank: int, ranks_on_host: int) -> Tuple[torch.device, str]:
    """The device of the ``local_rank``-th of ``ranks_on_host`` ranks on a
    host, and the backend of the process group: ``cuda:{local_rank %
    device_count}`` for ``"cuda"`` (an explicit ``cuda:i`` is shared by every
    local rank), and NCCL only when no two local ranks share a card. gloo
    serves ranks that share a card (NCCL refuses two ranks on one device)
    and ranks on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if dev.index is None:
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        shared = ranks_on_host > cards
    else:
        shared = ranks_on_host > 1
    return dev, "gloo" if shared else "nccl"
