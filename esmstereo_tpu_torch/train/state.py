"""Train state: the model, its optimizer and the LR schedule.

Counterpart of ``esmstereo_tpu/train/state.py``. The optimizer updates the
parameters (the JAX ``params``); the BatchNorms' running statistics are
buffers (``batch_stats``), which the training forward updates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


def make_optimizer(name: str, params, weight_decay: float = 0.01
                   ) -> torch.optim.Optimizer:
    """AdamW (the SceneFlow recipe, ``train_sceneflow.py:94``) or Adam (the
    KITTI finetune, ``train_kitti.py:79``), with optax's defaults: betas
    0.9 / 0.999, eps 1e-8 outside the square root; AdamW's decay 0.01 on
    every tensor (``optax.adamw`` without a mask), scaled by the LR as
    optax scales it. The LR is 1.0 here: ``lr_scheduler`` sets each step's
    from the schedule itself, so the optimizer runs the schedule's values
    unscaled."""
    params = list(params)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(name)


def lr_scheduler(optimizer: torch.optim.Optimizer,
                 lr_fn: Callable[[int], float]
                 ) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` that gives update ``i`` (from 0) the LR ``lr_fn(i)``,
    stepped once after each optimizer step."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lr_fn)


@dataclasses.dataclass
class TrainState:
    """The model, the optimizer over its parameters, the scheduler, and
    the number of updates made (``step``, optax's ``count``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def create_train_state(model: nn.Module, optimizer: str,
                       lr_fn: Callable[[int], float],
                       weight_decay: float = 0.01) -> TrainState:
    """A fresh train state over ``model``'s parameters."""
    opt = make_optimizer(optimizer, model.parameters(), weight_decay)
    return TrainState(model, opt, lr_scheduler(opt, lr_fn))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
