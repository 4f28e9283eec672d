"""Optimizer and scheduler factories, and checkpoint IO (flat npz).

Port of the JAX package's train/optim.py, which wires the reference's four
optimizer choices (reference lib/utils/funcs_utils.py:147-178) as optax
transforms. The port keeps optax's update rules, not torch.optim's defaults:

  * sgd: torch.optim.SGD is the same function as optax.sgd (trace
    t = g + momentum * t, update -lr * t; nesterov g + momentum * t), and its
    weight_decay adds wd * p to the gradient before the trace, as the JAX
    package's chain(add_decayed_weights, sgd) does;
  * adam / adamw: torch.optim.Adam / AdamW are optax.adam / adamw (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, bias-corrected; adamw's
    decoupled decay is lr * wd * p with the reference's fixed wd 0.1);
  * rmsprop: optax.rmsprop keeps nu = 0.9 nu + 0.1 g^2 and updates
    -lr * g / sqrt(nu + eps), eps INSIDE the root; torch.optim.RMSprop
    (alpha 0.99, eps outside) is another function, so OptaxRMSprop below
    implements optax's.

get_optimizer returns a factory, params -> torch.optim.Optimizer: like an
optax transform it is built before the parameters it will update.

Schedules and the plateau scheduler are host code. Checkpoints are the JAX
package's flat npz ('/'-joined tree paths plus __epoch__), written and read
through models.convert's flatten_tree / unflatten_tree, so a checkpoint
either package writes loads in the other.
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Iterable

import numpy as np
import torch


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr) (decay 0.9, eps 1e-8 inside the square root, no
    momentum, not centred): nu = decay * nu + (1 - decay) * g^2, then
    p -= lr * g / sqrt(nu + eps). nu starts at 0 (optax's initial_scale)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).addcmul_(g, g, value=1.0 - decay)
                p.sub_(lr * (g * torch.rsqrt(nu + eps)))
        return loss


def get_optimizer(
    name: str,
    lr: float,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    nesterov: bool = False,
) -> Callable[..., torch.optim.Optimizer]:
    """The reference's get_optimizer (funcs_utils.py:147-178) with the JAX
    package's optax semantics: a factory taking the parameters (an iterable
    of tensors or param groups) and returning the optimizer. adamw uses the
    reference's fixed weight_decay=0.1; sgd adds weight_decay * p to the
    gradient BEFORE the momentum trace (funcs_utils.py:154-160)."""
    if name == "sgd":
        return partial(torch.optim.SGD, lr=lr, momentum=momentum, nesterov=nesterov,
                       weight_decay=weight_decay)
    if name == "rmsprop":
        return partial(OptaxRMSprop, lr=lr)
    if name == "adam":
        return partial(torch.optim.Adam, lr=lr)
    if name == "adamw":
        return partial(torch.optim.AdamW, lr=lr, weight_decay=0.1)
    raise ValueError(f"unknown optimizer: {name}")


def step_schedule(base_lr: float, milestones: Iterable[int], gamma: float):
    """MultiStepLR equivalent (funcs_utils.py:184): the lr at a step count,
    base_lr times gamma for every milestone the count has reached."""
    milestones = sorted(milestones)

    def schedule(count) -> float:
        factor = 1.0
        for m in milestones:
            if count >= m:
                factor *= gamma
        return base_lr * factor

    return schedule


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau equivalent (funcs_utils.py:186), host-side state.

    Matches torch's defaults the reference relies on: mode='min' with the
    RELATIVE improvement threshold 1e-4 -- a metric only counts as better
    when it beats best * (1 - threshold), so a loss creeping down by less
    than 0.01% per epoch still accumulates bad epochs and drops the LR."""

    lr: float
    factor: float = 0.1
    patience: int = 10
    min_lr: float = 1e-5
    threshold: float = 1e-4
    best: float = field(default=float("inf"))
    bad_epochs: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def lr_warmup(base_lr: float, epoch: int, base_epochs: int) -> float:
    """funcs_utils.py:106-110."""
    return base_lr * (epoch / base_epochs)


def lr_check(lr, epoch: int) -> float:
    """Training-loop LR report (funcs_utils.py:96-104 parity): prints
    `Current epoch {epoch}, lr: {lr}`. The reference's warmup call is dead
    code (guarded by `if False and epoch <= base_epoch`), so none happens
    here either. Accepts a float lr or a schedule (called at `epoch`)."""
    curr_lr = float(lr(epoch)) if callable(lr) else float(lr)
    print(f"Current epoch {epoch}, lr: {curr_lr}")
    return curr_lr


def get_scheduler(
    name: str | None,
    base_lr: float,
    milestones: Iterable[int] = (),
    gamma: float = 0.1,
):
    """Config-driven scheduler factory (funcs_utils.py:181-189 parity).

    'step' -> MultiStepLR-equivalent schedule (step_schedule); 'platue' (the
    reference's spelling) -> host-side PlateauScheduler with the reference's
    hardwired mode='min', patience=10, min_lr=1e-5; any other name -> None,
    exactly like the reference's fall-through."""
    if name == "step":
        return step_schedule(base_lr, milestones, gamma)
    if name == "platue":
        return PlateauScheduler(lr=base_lr, factor=gamma, patience=10, min_lr=1e-5)
    return None


# ---------------------------------------------------------------------------
# Checkpoint IO: the JAX package's flat-npz tree store. Tensor leaves are
# written as numpy; loading gives the JAX package's tree of f32 arrays.
# ---------------------------------------------------------------------------
def _host_tree(tree: Dict) -> Dict:
    from poserisk_release_tpu_torch.models.convert import _to_np

    return {k: _host_tree(v) if isinstance(v, dict) else _to_np(v) for k, v in tree.items()}


def save_checkpoint(
    state: Dict, epoch: int, checkpoint_dir: str, end_epoch: int | None = None,
    is_best: bool = False,
) -> str:
    """save_checkpoint parity (funcs_utils.py:191-199): epoch_{N} naming,
    'final' at end_epoch, optional 'best' copy. state: a nested dict of
    arrays or tensors (TrainState.variables() is one)."""
    from poserisk_release_tpu_torch.models.convert import flatten_tree

    os.makedirs(checkpoint_dir, exist_ok=True)
    name = "final" if (end_epoch is not None and epoch == end_epoch) else f"epoch_{epoch}"
    path = osp.join(checkpoint_dir, name + ".npz")
    flat = flatten_tree(_host_tree(state))
    flat["__epoch__"] = np.asarray(epoch)
    np.savez(path, **flat)
    if is_best:
        np.savez(osp.join(checkpoint_dir, "best.npz"), **flat)
    return path


def load_checkpoint(path: str) -> Dict:
    from poserisk_release_tpu_torch.models.convert import unflatten_tree

    if not osp.isfile(path):
        raise ValueError(f"No checkpoint exists!\n {path}")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    flat.pop("__epoch__", None)
    return unflatten_tree(flat)
