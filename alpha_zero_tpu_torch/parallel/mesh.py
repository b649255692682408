"""The rank layout: a ``('dp', 'mdl')`` mesh of processes, each rank's
device and the collective backend.

The port of ``alpha_zero_tpu.parallel.mesh``. Only the data-parallel axis
is ported: every rank holds a full replica of the weights and its own rows
of the game and train batches. The model axis (JAX shards the convs' and
dense layers' output channels over ``mdl``) is ROADMAP A10b.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from alpha_zero_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    dp: int   # ranks, each with its share of the games and the train batch
    mdl: int  # always 1: the model axis is not ported


def check_mdl(mdl: int) -> None:
    if mdl > 1:
        raise NotImplementedError(
            f"parallel.mdl={mdl}: the model axis (column-parallel convs) is not "
            "ported yet (ROADMAP A10b); set parallel.mdl=1")


def make_mesh(dp: int, mdl: int = 1) -> Mesh:
    """The mesh of ``dp`` ranks; raises for ``mdl > 1``."""
    check_mdl(mdl)
    if dp < 1:
        raise ValueError(f"parallel.dp must be at least 1, got {dp}")
    return Mesh(dp=dp, mdl=1)


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
