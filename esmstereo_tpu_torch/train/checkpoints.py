"""Checkpoints: epoch-indexed torch files with resume and warm start.

Counterpart of ``esmstereo_tpu/train/checkpoints.py`` (the reference's
``train_sceneflow.py:96-112,156-158``), with ``torch.save`` in place of
orbax:

  * save ``{epoch, step, model, optimizer, scheduler}`` every
    ``save_freq`` epochs as ``<logdir>/checkpoint_{epoch:06d}``;
  * resume: restore the newest checkpoint of the logdir (parameters, batch
    statistics, optimizer, schedule, step) and go on at the next epoch;
  * warm start: load the tensors whose names and shapes match (the KITTI
    finetune from a SceneFlow checkpoint) and leave the optimizer fresh;
  * evaluation: load every tensor of the model, strictly (``load_weights``).
"""

from __future__ import annotations

import os
import re

import torch

_CKPT_RE = re.compile(r"checkpoint_(\d+)$")


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(logdir), f"checkpoint_{epoch:06d}")


def latest_checkpoint(logdir: str) -> str | None:
    if not os.path.isdir(logdir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(logdir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(os.path.abspath(logdir), name)
    return best


def save_checkpoint(logdir: str, state, epoch: int) -> str:
    """Write ``state`` (a ``train.state.TrainState``) after ``epoch``;
    returns the path. The file is written beside and renamed, so a crash
    leaves no half checkpoint under the name."""
    path = checkpoint_path(logdir, epoch)
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, "step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def _load(path: str) -> dict:
    """A checkpoint's tensors on the CPU: ``load_state_dict`` copies them
    to the model's device, and the optimizer's to each parameter's, with
    its step counts left on the CPU, where torch keeps them."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state):
    """Full restore (resume) into ``state`` in place: returns ``(state,
    next_epoch)``."""
    tree = _load(path)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    state.step = int(tree["step"])
    return state, int(tree["epoch"]) + 1


def save_weights(path: str, model: torch.nn.Module) -> str:
    """Write ``model``'s parameters and buffers alone, as a bare
    ``state_dict`` file that ``load_weights`` reads (the export CLI's
    ``--loadckpt``); returns the path. Written beside and renamed, as
    ``save_checkpoint``."""
    tmp = path + ".tmp"
    torch.save(model.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the parameters and buffers of a checkpoint (or of a bare
    ``state_dict`` file) into ``model``, every name and shape matching;
    raises on any key missing or left over."""
    tree = _load(path)
    model.load_state_dict(tree.get("model", tree))
    return model


def warm_start(path: str, state, log_fn=print):
    """Partial load by name intersection (``train_sceneflow.py:106-112``):
    the parameters and BatchNorm statistics of a checkpoint (or of a bare
    ``state_dict`` file) whose names and shapes match ``state.model``'s;
    the optimizer stays fresh. Prints the matched counts as the JAX
    package does."""
    model = state.model
    tree = _load(path)
    loaded = tree.get("model", tree)
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    with torch.no_grad():
        for label, current in (("params", params), ("batch_stats", stats)):
            hits = 0
            for k, v in current.items():
                lv = loaded.get(k)
                if lv is not None and tuple(lv.shape) == tuple(v.shape):
                    v.copy_(lv)
                    hits += 1
            log_fn(f"warm_start: {label}: matched {hits}/{len(current)} "
                   f"tensors")
    return state
