"""Train and eval steps.

Counterpart of ``esmstereo_tpu/train/step.py``: one train step is the
training forward (BatchNorm statistics updated), the multi-scale masked
loss, the backward pass, the optimizer and schedule steps, and EPE / D1 of
the full-res output, as the reference's ``train_sample``
(``train_sceneflow.py:196-227``). A batch keeps the JAX package's keys:
``left``, ``right`` (NHWC images), ``disparity`` and ``disparity_low``
(the /2, /4, /8, /16 GT maps), as numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from esmstereo_tpu_torch.models.losses import (disparity_masks,
                                               model_loss_test,
                                               model_loss_train)
from esmstereo_tpu_torch.utils.metrics import (d1_metric, epe_metric,
                                               eval_metrics)

TRAIN_KEYS = ("left", "right", "disparity", "disparity_low")
EVAL_KEYS = ("left", "right", "disparity")


def _tensor(x, device: torch.device, non_blocking: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    if non_blocking and t.device.type == "cpu" and device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)


def batch_to_device(batch: dict, device, keys=TRAIN_KEYS,
                    non_blocking: bool = False) -> dict:
    """The entries ``keys`` of ``batch`` as tensors on ``device`` (lists
    entry by entry); with ``non_blocking`` from pinned host memory, so
    the copy runs on the current stream without holding the host."""
    device = torch.device(device)
    out = {}
    for k in keys:
        if k not in batch:
            continue
        v = batch[k]
        out[k] = ([_tensor(x, device, non_blocking) for x in v]
                  if isinstance(v, (list, tuple))
                  else _tensor(v, device, non_blocking))
    return out


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(model: torch.nn.Module, fix_cv16: bool = False):
    """``train_step(state, batch) -> metrics``: one update of
    ``state`` (a ``train.state.TrainState`` over ``model``), in place.
    ``metrics`` holds 0-d tensors on the model's device (``loss``, ``EPE``,
    ``D1``), computed from this step's forward; reading them is the
    caller's sync. Every parameter is updated, as optax updates every leaf:
    one the loss does not reach (S's /32 stage) gets a zero gradient, so
    AdamW still decays it."""
    cfg = model.config
    params = list(model.parameters())

    def train_step(state, batch: dict) -> dict:
        model.train()
        b = batch_to_device(batch, model_device(model))
        gts = [b["disparity"], *b.get("disparity_low", [])]
        masks = disparity_masks(gts, cfg.max_disp)
        outs = model(b["left"], b["right"])
        loss = model_loss_train(outs, gts, masks, cfg.cv_scale,
                                fix_cv16=fix_cv16)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            full = outs[0].detach()
            return {"loss": loss.detach(),
                    "EPE": epe_metric(full, gts[0], masks[0]),
                    "D1": d1_metric(full, gts[0], masks[0])}

    return train_step


def make_eval_step(model: torch.nn.Module):
    """``eval_step(state, batch) -> (metrics, disparity)``: the eval
    forward (kernels on the card) under ``torch.inference_mode``, the five
    ``eval_metrics`` and ``loss`` (``model_loss_test``), 0-d tensors on
    the device. ``state`` may be None: the step reads ``model``."""
    max_disp = model.config.max_disp

    def eval_step(state, batch: dict):
        model.eval()
        b = batch_to_device(batch, model_device(model), EVAL_KEYS)
        with torch.inference_mode():
            outs = model(b["left"], b["right"])
            gt = b["disparity"]
            mask = (gt > 0) & (gt < max_disp)
            metrics = eval_metrics(outs[0], gt, mask)
            metrics["loss"] = model_loss_test(outs, [gt], [mask])
        return metrics, outs[0]

    return eval_step


def make_infer_fn(model: torch.nn.Module):
    """``infer(left, right)``: the eval forward's full-res disparity (B,
    H, W) on NHWC images (arrays or tensors)."""

    def infer(left, right) -> torch.Tensor:
        model.eval()
        dev = model_device(model)
        with torch.inference_mode():
            return model(_tensor(left, dev, False),
                         _tensor(right, dev, False))[0]

    return infer
