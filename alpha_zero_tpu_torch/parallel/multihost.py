"""Process groups and the collectives of data- and model-parallel training.

The port of ``alpha_zero_tpu.parallel.multihost`` over ``torch.distributed``
(see the package docstring for the mapping). There are ``dp * mdl`` ranks
(``parallel/mesh.py``); the ``mdl`` ranks of a model group play the same
games and train on the same rows, each computing its slice of the wide
layers' output channels. What crosses ranks:

- the generation fence: ``global_sum`` of the per-rank counters (finished
  games, resign-marked, could-have-won, samples) every
  ``parallel.fence_interval`` self-play steps, over a data group so that
  each model group's games count once, so every rank leaves self-play on
  the same step; rank 0 runs the resignation controller on the global
  stream and ``broadcast_from_host0`` sends its threshold back;
- the learner: each BatchNorm layer's moments (``all_reduce_sum`` over the
  data group, in ``models/resnet.py:batch_moments``) and
  ``average_gradients`` once a step;
- the model axis (``mdl > 1``): ``copy_to_model`` on the input and
  ``all_gather_channels`` on the output of every column-parallel layer
  (``models/resnet.py``), the Megatron pair of collectives;
- start-up: ``broadcast_tensors`` of the weights and optimizer state from
  the first rank of each data group.

Each of these is a collective: every rank of its group must call it at the
same point, in the same order. The helpers ``rank``, ``world_size``,
``is_host0`` and ``mesh`` give 0, 1, True and a 1 x 1 mesh when no process
group is up, and then every collective returns its input.
"""

from __future__ import annotations

import socket
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alpha_zero_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_device
from alpha_zero_tpu_torch.utils.logging import create_logger


class _Layout(NamedTuple):
    mesh: Mesh
    model_group: Optional[dist.ProcessGroup]  # this rank's; None when mdl == 1
    data_group: Optional[dist.ProcessGroup]   # this rank's; None (the world) when mdl == 1


# The process's layout beside torch.distributed's own default group: set by
# ``initialize``, cleared by ``shutdown``.
_layout: Optional[_Layout] = None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_host0() -> bool:
    return rank() == 0


def mesh() -> Mesh:
    """This process group's mesh: ``dp = world``, ``mdl = 1`` unless
    ``initialize`` was given a model axis."""
    return _layout.mesh if _layout is not None else Mesh(world_size(), 1)


def _data_group() -> Optional[dist.ProcessGroup]:
    return _layout.data_group if _layout is not None else None


def dp_index() -> int:
    return mesh().coords(rank())[0]


def mdl_index() -> int:
    return mesh().coords(rank())[1]


def local_address() -> str:
    """``localhost:<port>`` with a port that was free just now, for ranks
    started on this host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device="cuda", mdl: int = 1) -> torch.device:
    """Makes this process rank ``process_id`` of ``num_processes`` on a mesh
    of ``mdl`` ranks a model group, and returns its device.
    ``coordinator_address`` (``host:port``) is where rank 0 serves the TCP
    store every rank meets at. The ranks trade host names through the store
    first, so each knows how many ranks share its host and picks its card
    and the backend (``mesh.rank_device``); the choice is logged once, by
    rank 0. With ``mdl > 1`` every rank then makes every model group and
    every data group, in the same order."""
    global _layout
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} "
                         "processes: set parallel.num_processes and parallel.process_id")
    layout = make_mesh(num_processes, mdl)
    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0)
    store.set(f"hostname/{process_id}", socket.gethostname())
    hosts = [store.get(f"hostname/{r}").decode() for r in range(num_processes)]
    local = [r for r, h in enumerate(hosts) if h == hosts[process_id]]
    dev, backend = rank_device(device, local.index(process_id), len(local))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes)
    model_group = data_group = None
    if layout.mdl > 1:
        dp_at, mdl_at = layout.coords(process_id)
        groups = [dist.new_group([i * layout.mdl + j for j in range(layout.mdl)])
                  for i in range(layout.dp)]
        model_group = groups[dp_at]
        groups = [dist.new_group([i * layout.mdl + j for i in range(layout.dp)])
                  for j in range(layout.mdl)]
        data_group = groups[mdl_at]
    _layout = _Layout(layout, model_group, data_group)
    if process_id == 0:
        why = ("every rank on a card of its own" if backend == "nccl"
               else "ranks on the CPU or sharing a card")
        create_logger().info(f"process group: {num_processes} ranks (dp={layout.dp} x "
                             f"mdl={layout.mdl}) on {len(set(hosts))} host(s), backend "
                             f"{backend} ({why}); rank 0 on {dev}")
    return dev


def shutdown() -> None:
    global _layout
    _layout = None
    if _initialized():
        dist.destroy_process_group()


def _control_device() -> torch.device:
    """Where the small control tensors go: the card under NCCL, which
    reduces nothing else, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(local_values) -> np.ndarray:
    """Element-wise sum of a small int64 vector over the data group (one
    ``all_reduce``): each model group's values once, since its ranks play
    the same games. A collective."""
    arr = np.atleast_1d(np.asarray(local_values, np.int64))
    if mesh().dp == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_control_device())
    dist.all_reduce(t, group=_data_group())
    return t.cpu().numpy()


def global_game_count(local_count: int) -> int:
    """Sum of one count over the model groups. A collective."""
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
    """Overwrites each tensor in place with the first rank's of its data
    group (rank 0's when ``mdl = 1``): ranks of one ``mdl_index`` hold the
    same slices. A collective."""
    if mesh().dp == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=mdl_index(), group=_data_group())


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data group, differentiable: its backward is
    the sum of the ranks' gradients, since every rank's loss reads the sum.
    A collective, in the backward pass too."""
    return _AllReduceSum.apply(t, _data_group())


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_layout.model_group)
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; its backward sums the gradient over the model group.
    Each rank of the group computes its output channels of a
    column-parallel layer from the whole ``x``, so its gradient of ``x`` is
    one part of the sum: without the sum every layer upstream of a sharded
    one would get 1/mdl of its gradient. A collective in the backward pass
    (Megatron's f)."""
    if mesh().mdl == 1:
        return x
    return _CopyToModel.apply(x)


def gather_slices(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's slices ``x`` joined along ``dim`` in rank order
    (``dist.all_gather``'s list form), in ``x``'s memory layout: a conv's
    output is channels-last when its input was (the net's NHWC planes), and
    the next conv of the whole net would see it so; a layout change would
    send that conv down another kernel. gloo moves a CUDA tensor through
    the host: that is the transport of this collective, and the compute
    stays on the card. A collective over the model group."""
    group = _layout.model_group
    n = dist.get_world_size(group)
    # The dims from outermost to innermost in memory, so that the permuted
    # tensor is contiguous without a copy.
    order = sorted(range(x.dim()), key=x.stride, reverse=True)
    at = order.index(dim % x.dim())
    local = x.permute(order).contiguous()
    if local.is_cuda and dist.get_backend(group) == "gloo":
        host = local.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        whole = torch.cat(parts, dim=at).to(x.device)
    else:
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        whole = torch.cat(parts, dim=at)
    return whole.permute([order.index(d) for d in range(x.dim())])


class _AllGatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        return gather_slices(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, mdl_index() * ctx.width, ctx.width).contiguous(), None


def all_gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model group's slices of ``x`` along ``dim`` joined in rank order:
    the whole output of a column-parallel layer on every rank. Its backward
    keeps this rank's slice of the gradient, which is identical on every
    rank of the group, and does not sum it (a summing all-gather would give
    ``mdl`` times the gradient). ``all_gather_channels.calls`` counts the
    forward gathers. A collective in the forward pass (Megatron's g)."""
    if mesh().mdl == 1:
        return x
    all_gather_channels.calls += 1
    return _AllGatherChannels.apply(x, dim)


all_gather_channels.calls = 0


def _mean_into(tensors: Sequence[torch.Tensor], n: int, group) -> torch.Tensor:
    """Replaces each tensor in place with its mean over ``group`` of ``n``
    ranks (one ``all_reduce`` of them flattened); returns the flat means."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat


def average_gradients(sharded: Sequence[torch.nn.Parameter],
                      replicated: Sequence[torch.nn.Parameter],
                      *scalars: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Replaces every parameter's gradient with its mean across model groups
    and returns each of ``scalars`` (0-d tensors of the gradients' dtype,
    such as the losses) as its mean: with equal local batches that is the
    gradient, and the loss, of the whole global batch.

    A ``sharded`` parameter (a slice of a column-parallel layer) is averaged
    over its data group. The ``replicated`` ones and the scalars are
    averaged over the whole world, one ``all_reduce`` of all of them
    flattened: the ranks of a model group hold the same values in exact
    arithmetic, so that is their mean over the data group, and it leaves
    the replicas the same bits even where a backward kernel is not
    deterministic. Every rank gets the same bits (each element is reduced
    once and shared). A collective."""
    m = mesh()
    if sharded and m.dp > 1:
        _mean_into([p.grad for p in sharded], m.dp, _data_group())
    flat = _mean_into([p.grad for p in replicated] + [s.reshape(1) for s in scalars],
                      world_size(), None)
    return tuple(flat[flat.numel() - len(scalars):].unbind()) if scalars else ()
