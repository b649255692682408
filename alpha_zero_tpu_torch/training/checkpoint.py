"""Train-state checkpoints, and the JAX package's train state carried over.

The port of ``alpha_zero_tpu.training.checkpoint``, with ``torch.save`` in
place of orbax. A checkpoint ``ckpt_dir/training_steps_{t}`` is one file
holding the float32 ``state_dict`` (BN running statistics included), the
optimizer state (momentum buffers), the scheduler state and
``training_steps``, so training resumes bit-exact. It is written to a
temporary file first and moved into place with ``os.replace``.

A checkpoint is always the whole layout, whatever ``parallel.mdl`` the run
had: a sharded net's slices and their momentum buffers are gathered over
the model group before the write and cut to the restoring rank's slices
after the read, so a checkpoint of one layout resumes in any other and
``cli.match``, the evaluator and ``tools/ckpt_to_torch.py`` read it as is.

``train_state_from_flax`` turns a JAX ``TrainState`` (numpy leaves: params,
batch_stats, the optax momentum trace and the step) into the port's
``TrainState``; ``tools/ckpt_to_torch.py`` uses it to convert orbax
checkpoints. This package never reads orbax itself.
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Tuple

import torch

from alpha_zero_tpu_torch.models.resnet import (build_network, gather_state_dict,
                                                params_from_flax, shard_state_dict)
from alpha_zero_tpu_torch.parallel import multihost
from alpha_zero_tpu_torch.training.learner import TrainState, create_train_state
from alpha_zero_tpu_torch.utils.device import resolve_device


def checkpoint_path(ckpt_dir: str, training_steps: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"training_steps_{training_steps}"))


def _momentum_by_name(state: TrainState, optimizer_state: dict) -> dict:
    """``optimizer_state["state"]``'s momentum buffers by parameter name."""
    names = [name for name, _ in state.net.named_parameters()]
    return {names[i]: s["momentum_buffer"] for i, s in optimizer_state["state"].items()}


def _with_momentum(optimizer_state: dict, state: TrainState, buffers: dict) -> dict:
    """``optimizer_state`` with its momentum buffers replaced by ``buffers``
    (by parameter name)."""
    names = [name for name, _ in state.net.named_parameters()]
    return {**optimizer_state, "state": {
        i: {**s, "momentum_buffer": buffers[names[i]]}
        for i, s in optimizer_state["state"].items()}}


def save_checkpoint(ckpt_dir: str, state: TrainState, training_steps: int,
                    write: bool = True) -> str:
    """Writes ``ckpt_dir/training_steps_{t}`` atomically (making the
    directory if needed) in the whole layout; returns its path. With a
    sharded net a collective over the model group: every rank of the group
    calls it, and the ranks with ``write=False`` only help gather."""
    path = checkpoint_path(ckpt_dir, training_steps)
    optimizer = state.optimizer.state_dict()
    payload = {
        "net": gather_state_dict(state.net),
        "optimizer": _with_momentum(optimizer, state, gather_state_dict(
            state.net, _momentum_by_name(state, optimizer))),
        "scheduler": state.scheduler.state_dict(),
        "training_steps": int(state.training_steps),
    }
    if not write:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Loads the checkpoint at ``path`` (the whole layout) into ``target``
    (a state of the same architecture, on its device; with a sharded net,
    cut to this rank's slices) and returns it."""
    device = next(target.net.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    net, optimizer = payload["net"], payload["optimizer"]
    if target.net.sharded_names():
        mesh, index = multihost.mesh(), multihost.mdl_index()
        net = shard_state_dict(net, mesh, index)
        optimizer = _with_momentum(optimizer, target, shard_state_dict(
            _momentum_by_name(target, optimizer), mesh, index))
    target.net.load_state_dict(net)
    target.optimizer.load_state_dict(optimizer)
    target.scheduler.load_state_dict(payload["scheduler"])
    target.training_steps = int(payload["training_steps"])
    return target


def states_equal(a: TrainState, b: TrainState) -> bool:
    """Two states bit for bit: weights and BN buffers, momentum buffers,
    schedule and step (what a checkpoint must give back)."""
    sa, sb = a.net.state_dict(), b.net.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.training_steps == b.training_steps and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and oa["param_groups"] == ob["param_groups"]
            and oa["state"].keys() == ob["state"].keys()
            and all(torch.equal(oa["state"][k]["momentum_buffer"],
                                ob["state"][k]["momentum_buffer"]) for k in oa["state"])
            and a.scheduler.state_dict() == b.scheduler.state_dict())


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """``(training_steps, name)`` of every checkpoint in ``ckpt_dir``, in
    step order. Names that do not end in a step (a ``.tmp`` file a crash
    left mid-write) are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("training_steps_"):
            try:
                found.append((int(name.rsplit("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(found)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1][1]) if found else None


def checkpoint_step(path: str) -> int:
    return int(os.path.basename(path).rsplit("_", 1)[1])


# ---------------------------------------------------------------------------
# The JAX package's train state
# ---------------------------------------------------------------------------


def _momentum_trace(opt_state: Any) -> Optional[Mapping]:
    """The ``trace`` tree of optax's ``TraceState`` inside the chain state
    (a tuple of named tuples, or the nested dicts of an untyped restore)."""
    if isinstance(opt_state, Mapping):
        if "trace" in opt_state:
            return opt_state["trace"]
        items = list(opt_state.values())
    elif hasattr(opt_state, "trace"):
        return opt_state.trace
    elif isinstance(opt_state, (list, tuple)):
        items = list(opt_state)
    else:
        return None
    for item in items:
        trace = _momentum_trace(item)
        if trace is not None:
            return trace
    return None


def _lr_at(train_cfg, step: int) -> float:
    """The rate ``MultiStepLR`` holds after ``step`` scheduler steps."""
    lr = train_cfg.init_lr
    for milestone in sorted(int(m) for m in train_cfg.lr_milestones):
        if step >= milestone:
            lr *= train_cfg.lr_decay
    return lr


def train_state_from_flax(np_tree: Mapping, env_cfg, net_cfg, train_cfg,
                          device="cuda") -> TrainState:
    """The port's ``TrainState`` from a JAX ``TrainState`` given as a mapping
    of numpy trees ``{"params", "batch_stats", "opt_state",
    "training_steps"}``: float32 weights and BN statistics
    (``params_from_flax``), optax's momentum trace as SGD's momentum
    buffers, the schedule at the step. Needs no JAX."""
    dev = resolve_device(device)
    net = build_network(env_cfg, net_cfg, device=dev, dtype="float32")
    net.load_state_dict(params_from_flax(np_tree))
    state = create_train_state(net, train_cfg)
    steps = int(np_tree["training_steps"])
    trace = _momentum_trace(np_tree["opt_state"])
    if trace is None:
        raise ValueError("opt_state holds no momentum trace (optax TraceState)")
    buffers = params_from_flax({"params": trace})
    for name, param in state.net.named_parameters():
        state.optimizer.state[param]["momentum_buffer"] = buffers[name].to(dev).clone()
    lr = _lr_at(train_cfg, steps)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    sched = state.scheduler.state_dict()
    sched.update(last_epoch=steps, _last_lr=[lr] * len(state.optimizer.param_groups))
    state.scheduler.load_state_dict(sched)
    state.training_steps = steps
    return state
