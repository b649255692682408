"""The learner: an SGD+momentum train step with dihedral augmentation.

The port of ``alpha_zero_tpu.training.learner``:

- loss: softmax cross-entropy of the policy logits against the full search
  distribution, plus the MSE of the tanh value, both in float32;
- optimizer: ``torch.optim.SGD(momentum, weight_decay)`` over every
  parameter, BN scale and bias included — what the JAX package's optax
  chain ``add_decayed_weights -> trace -> scale_by_learning_rate`` computes
  (both start the momentum trace from the first gradient);
- schedule: ``MultiStepLR``, stepped once after each optimizer step, so the
  step that follows k earlier updates uses the rate of step k, as optax's
  piecewise-constant schedule of the update count does;
- the net keeps float32 master weights and computes in the config's
  inference dtype under ``torch.autocast`` (Flax ``dtype=bfloat16`` with
  float32 params); its BatchNorm layers run Flax's train-mode statistics.

Data parallel (a process group of more than one rank, ``parallel/``):
each model group steps on its rows of the global batch, the BatchNorm
moments are the global batch's (``models/resnet.py:batch_moments``), and
``average_gradients`` averages the gradients and the two losses across
model groups before the optimizer step, so every rank takes the global
batch's step and reports its losses (XLA's psum of the dp-sharded step in
the JAX package). With the model axis the net holds this rank's slices of
the wide layers: their gradients are averaged over the data group, and
SGD with weight decay updates each slice where it lives.

PyTorch idiom: the state holds the module, optimizer and scheduler, and a
train step updates it in place. The augmentation pick is an input (the
transform id), drawn by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from alpha_zero_tpu_torch.ops.symmetry import IDENTITY, apply_transform
from alpha_zero_tpu_torch.parallel import multihost


@dataclasses.dataclass
class TrainState:
    net: nn.Module     # either net of build_network: float32 master weights, train mode
    optimizer: torch.optim.SGD
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    training_steps: int = 0


class TrainMetrics(NamedTuple):
    policy_loss: torch.Tensor  # f32 scalar on the net's device
    value_loss: torch.Tensor   # f32 scalar on the net's device
    learning_rate: float       # the rate this step used


def make_lr_schedule(optimizer: torch.optim.Optimizer, lr_decay: float,
                     milestones) -> torch.optim.lr_scheduler.MultiStepLR:
    """Multiplies the rate by ``lr_decay`` at each milestone."""
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) for m in milestones], gamma=lr_decay)


def make_optimizer(params, init_lr: float, lr_decay: float, milestones,
                   momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD + momentum + L2 (the decay term enters the gradient before the
    momentum buffer) and its schedule."""
    optimizer = torch.optim.SGD(params, lr=init_lr, momentum=momentum,
                                weight_decay=weight_decay)
    return optimizer, make_lr_schedule(optimizer, lr_decay, milestones)


def create_train_state(net: nn.Module, train_cfg) -> TrainState:
    """A fresh state around ``net`` (float32), put in train mode."""
    optimizer, scheduler = make_optimizer(
        net.parameters(), train_cfg.init_lr, train_cfg.lr_decay,
        train_cfg.lr_milestones, momentum=train_cfg.sgd_momentum,
        weight_decay=train_cfg.l2_regularization)
    return TrainState(net=net.train(), optimizer=optimizer, scheduler=scheduler)


def loss_fn(net: nn.Module, states: torch.Tensor, target_pi: torch.Tensor,
            target_v: torch.Tensor, compute_dtype: torch.dtype):
    """(policy_loss, value_loss) of ``net`` in train mode on one batch."""
    with torch.autocast(states.device.type, dtype=compute_dtype,
                        enabled=compute_dtype != torch.float32):
        out = net(states)
    log_probs = F.log_softmax(out.pi_logits.float(), dim=-1)
    policy_loss = -(target_pi * log_probs).sum(dim=-1).mean()
    value_loss = torch.mean(torch.square(out.value.float() - target_v))
    return policy_loss, value_loss


def make_train_step(compute_dtype: str = "float32", argument_data: bool = True):
    """Returns ``train_step(state, states, target_pi, target_v,
    transform_id=0) -> TrainMetrics``, which updates ``state`` in place.

    ``states`` int8 NHWC, ``target_pi`` f32 [B, A], ``target_v`` f32 [B], on
    the net's device. With ``argument_data`` the batch is transformed by
    ``transform_id`` (``ops.symmetry``) before the forward pass."""
    dtype = getattr(torch, compute_dtype)

    def train_step(state: TrainState, states: torch.Tensor, target_pi: torch.Tensor,
                   target_v: torch.Tensor, transform_id: int = IDENTITY) -> TrainMetrics:
        if argument_data:
            states, target_pi = apply_transform(states, target_pi, transform_id)
        learning_rate = state.optimizer.param_groups[0]["lr"]
        policy_loss, value_loss = loss_fn(state.net, states, target_pi, target_v, dtype)
        state.optimizer.zero_grad(set_to_none=True)
        (policy_loss + value_loss).backward()
        if multihost.world_size() > 1:
            sharded = state.net.sharded_names()
            params = list(state.net.named_parameters())
            policy_loss, value_loss = multihost.average_gradients(
                [p for n, p in params if n in sharded], [p for n, p in params if n not in sharded],
                policy_loss.detach(), value_loss.detach())
        state.optimizer.step()
        state.scheduler.step()
        state.training_steps += 1
        return TrainMetrics(policy_loss=policy_loss.detach(),
                            value_loss=value_loss.detach(),
                            learning_rate=learning_rate)

    return train_step
