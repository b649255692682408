"""Process groups and the few collectives of data-parallel training.

The port of ``alpha_zero_tpu.parallel.multihost`` over ``torch.distributed``
(see the package docstring for the mapping). Every rank runs the same
Trainer loop on its own rows: its games, its replay partition, its share of
each train batch. What crosses ranks:

- the generation fence: ``global_sum`` of the per-rank counters (finished
  games, resign-marked, could-have-won, samples) every
  ``parallel.fence_interval`` self-play steps, so every rank leaves
  self-play on the same step; rank 0 runs the resignation controller on
  the global stream and ``broadcast_from_host0`` sends its threshold back;
- the learner: each BatchNorm layer's moments (``all_reduce_sum`` in
  ``models/resnet.py:batch_moments``) and ``average_gradients`` once a step;
- start-up: ``broadcast_tensors`` of rank 0's weights and optimizer state.

Each of these is a collective: every rank must call it at the same point,
in the same order. The helpers ``rank``, ``world_size`` and ``is_host0``
give 0, 1 and True when no process group is up, and then every collective
returns its input.
"""

from __future__ import annotations

import socket
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alpha_zero_tpu_torch.parallel.mesh import rank_device
from alpha_zero_tpu_torch.utils.logging import create_logger


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_host0() -> bool:
    return rank() == 0


def local_address() -> str:
    """``localhost:<port>`` with a port that was free just now, for ranks
    started on this host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device="cuda") -> torch.device:
    """Makes this process rank ``process_id`` of ``num_processes`` and
    returns its device. ``coordinator_address`` (``host:port``) is where
    rank 0 serves the TCP store every rank meets at. The ranks trade host
    names through the store first, so each knows how many ranks share its
    host and picks its card and the backend (``mesh.rank_device``); the
    choice is logged once, by rank 0."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} "
                         "processes: set parallel.num_processes and parallel.process_id")
    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0)
    store.set(f"hostname/{process_id}", socket.gethostname())
    hosts = [store.get(f"hostname/{r}").decode() for r in range(num_processes)]
    local = [r for r, h in enumerate(hosts) if h == hosts[process_id]]
    dev, backend = rank_device(device, local.index(process_id), len(local))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes)
    if process_id == 0:
        why = ("every rank on a card of its own" if backend == "nccl"
               else "ranks on the CPU or sharing a card")
        create_logger().info(f"process group: {num_processes} ranks on {len(set(hosts))} "
                             f"host(s), backend {backend} ({why}); rank 0 on {dev}")
    return dev


def shutdown() -> None:
    if _initialized():
        dist.destroy_process_group()


def _control_device() -> torch.device:
    """Where the small control tensors go: the card under NCCL, which
    reduces nothing else, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(local_values) -> np.ndarray:
    """Element-wise sum of a small int64 vector across ranks (one
    ``all_reduce``). A collective."""
    arr = np.atleast_1d(np.asarray(local_values, np.int64))
    if world_size() == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_control_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def global_game_count(local_count: int) -> int:
    """Sum of one count across ranks. A collective."""
    return int(global_sum(local_count)[0])


def broadcast_from_host0(value: float) -> float:
    """Rank 0's ``value`` on every rank (float64, so a Python float or an
    int below 2**53 arrives unchanged). A collective."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_control_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrites each tensor in place with rank 0's. A collective."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` across ranks, differentiable: its backward is the
    sum of the ranks' gradients, since every rank's loss reads the sum.
    A collective, in the backward pass too."""
    return _AllReduceSum.apply(t)


def average_gradients(params: Sequence[torch.nn.Parameter],
                      *scalars: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Replaces every parameter's gradient with its mean across ranks and
    returns each of ``scalars`` (0-d tensors of the gradients' dtype, such
    as the losses) as its mean across ranks: one ``all_reduce`` of all of
    them flattened. With equal local batches that is the gradient, and the
    loss, of the whole global batch. Every rank gets the same bits (each
    element is reduced once and shared). A collective."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1) for s in scalars])
    dist.all_reduce(flat)
    flat.div_(world_size())
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return tuple(flat[offset:].unbind())
