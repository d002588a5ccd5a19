"""The training loop: the engine of the training recipes.

Counterpart of ``esmstereo_tpu/train/loop.py`` (the reference's
``train_sceneflow.py`` / ``train_kitti.py`` scripts): the epoch loop on the
``lrepochs`` schedule, per-step console logging, a checkpoint every
``save_freq`` epochs, resume and warm start, and full-test evaluation with
best-metric tracking. The loop runs where the model lies (the port builds
its models on the card unless asked for the CPU); the training forward
takes the plain modules at every kernel site, and the evaluation runs the
kernels.

The host stays ahead of the card: batch i+1's host-to-device copy is
started on a side stream before step i runs (``device_batches``), and
step i's metrics are read back (a sync) only after step i+1 has been
dispatched, so console and logger lag the card by one step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from esmstereo_tpu_torch.train import checkpoints as ckpt
from esmstereo_tpu_torch.train.schedule import lr_schedule_fn
from esmstereo_tpu_torch.train.state import create_train_state
from esmstereo_tpu_torch.train.step import (EVAL_KEYS, TRAIN_KEYS,
                                            batch_to_device, make_eval_step,
                                            make_train_step, model_device)
from esmstereo_tpu_torch.utils.meters import (AverageMeter, AverageMeterDict,
                                              save_images, save_scalars)


@dataclasses.dataclass
class TrainLoopConfig:
    """The JAX loop's fields and defaults (the SceneFlow recipe). ``seed``
    is kept for that field set: the port's model has drawn its weights
    when it was built (``ESMStereo(seed=...)``)."""

    epochs: int = 60
    lr: float = 1e-3
    lrepochs: str = "20,32,40,48,56:2"
    optimizer: str = "adamw"
    logdir: str = "./logs"
    resume: bool = False
    loadckpt: str = ""
    save_freq: int = 1
    summary_freq: int = 1
    max_batches_per_epoch: int | None = None   # KITTI caps at 100
    select_metric: str = "EPE"                 # KITTI selects on D1
    fix_cv16_loss: bool = False
    seed: int = 1
    # image dumps (left / GT / estimate / error map) every `image_freq`
    # steps through `logger.add_image`; 0 = off
    image_freq: int = 0


def _all_tensors(batch: dict):
    for v in batch.values():
        yield from (v if isinstance(v, list) else [v])


def device_batches(loader, device, keys=TRAIN_KEYS, limit=None):
    """Yield ``(device_batch, host_batch)``, starting batch i+1's copy
    before batch i is yielded: on a CUDA device from pinned memory on a
    side stream, which the consumer's stream waits for (and marks the
    tensors used on it, for the caching allocator)."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    prev = None
    for bi, batch in enumerate(loader):
        if limit is not None and bi >= limit:
            break
        if side is None:
            dev, done = batch_to_device(batch, device, keys), None
        else:
            with torch.cuda.stream(side):
                dev = batch_to_device(batch, device, keys, non_blocking=True)
                done = side.record_event()
        if prev is not None:
            yield _arrived(*prev, device)
        prev = (dev, batch, done)
    if prev is not None:
        yield _arrived(*prev, device)


def _arrived(dev: dict, host: dict, done, device: torch.device):
    if done is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in _all_tensors(dev):
            t.record_stream(stream)
    return dev, host


def run_training(model: torch.nn.Module, cfg: TrainLoopConfig,
                 train_loader, test_loader, *, logger=None,
                 log_fn: Callable[[str], None] = print) -> dict:
    """Run the recipe on ``model`` (trained in place); returns
    ``{"best_epoch", "best_metric", "state"}`` (``state`` the
    ``train.state.TrainState`` at the end). ``logger`` is anything with
    ``add_scalar`` (and ``add_image`` for ``image_freq``), or None."""
    os.makedirs(cfg.logdir, exist_ok=True)
    device = model_device(model)
    steps_per_epoch = len(train_loader)
    if cfg.max_batches_per_epoch:
        steps_per_epoch = min(steps_per_epoch, cfg.max_batches_per_epoch)
    state = create_train_state(
        model, cfg.optimizer,
        lr_schedule_fn(cfg.lr, cfg.lrepochs, steps_per_epoch))

    start_epoch = 0
    if cfg.resume:
        latest = ckpt.latest_checkpoint(cfg.logdir)
        if latest:
            log_fn(f"resuming from {latest}")
            state, start_epoch = ckpt.restore_checkpoint(latest, state)
    elif cfg.loadckpt:
        log_fn(f"warm-starting from {cfg.loadckpt}")
        state = ckpt.warm_start(cfg.loadckpt, state, log_fn)

    train_step = make_train_step(model, fix_cv16=cfg.fix_cv16_loss)
    eval_step = make_eval_step(model)

    best_epoch, best_metric = -1, float("inf")
    for epoch in range(start_epoch, cfg.epochs):
        train_loader.set_epoch(epoch)
        loss_m, epe_m, d1_m = AverageMeter(), AverageMeter(), AverageMeter()
        t_epoch = time.time()

        def flush(pending):
            bi, gstep, metrics, host_batch, t0, disp_est = pending
            metrics = {k: float(v) for k, v in metrics.items()}
            loss_m.update(metrics["loss"])
            epe_m.update(metrics["EPE"])
            d1_m.update(metrics["D1"])
            if gstep % cfg.summary_freq == 0:
                save_scalars(logger, "train",
                             {"loss": metrics["loss"],
                              "EPE": [metrics["EPE"]],
                              "D1": [metrics["D1"]]}, gstep)
            if disp_est is not None:
                est = disp_est[0].float().cpu().numpy()       # (H, W)
                gt = np.asarray(host_batch["disparity"][0])
                save_images(logger, "train", {
                    "imgL": np.asarray(host_batch["left"][0]),
                    "disp_gt": gt, "disp_est": est,
                    "errormap": np.abs(est - gt) * (gt > 0)}, gstep)
            log_fn(
                f"Epoch {epoch}/{cfg.epochs} | Iter {bi}/{steps_per_epoch} | "
                f"loss {metrics['loss']:.3f}({loss_m.avg:.3f}) | "
                f"EPE {metrics['EPE']:.3f}({epe_m.avg:.3f}) | "
                f"D1 {metrics['D1']:.3f}({d1_m.avg:.3f}) | "
                f"time {time.time() - t0:.3f}")

        pending = None
        for bi, (dev_batch, host_batch) in enumerate(device_batches(
                train_loader, device, limit=cfg.max_batches_per_epoch)):
            gstep = steps_per_epoch * epoch + bi
            t0 = time.time()
            metrics = train_step(state, dev_batch)
            disp_est = None
            if (logger is not None and cfg.image_freq
                    and gstep % cfg.image_freq == 0):
                # the just-updated weights, read back in the late flush
                _, disp_est = eval_step(state, {
                    k: dev_batch[k] for k in EVAL_KEYS})
            if pending is not None:
                flush(pending)
            pending = (bi, gstep, metrics, host_batch, t0, disp_est)
        if pending is not None:
            flush(pending)

        if (epoch + 1) % cfg.save_freq == 0:
            path = ckpt.save_checkpoint(cfg.logdir, state, epoch)
            log_fn(f"saved {path}")

        if test_loader is not None:
            avg = AverageMeterDict()
            for dev_batch, _ in device_batches(test_loader, device,
                                               EVAL_KEYS):
                metrics, _ = eval_step(state, dev_batch)
                avg.update({k: [float(v)] if k != "loss" else float(v)
                            for k, v in metrics.items()})
            means = avg.mean()
            save_scalars(logger, "fulltest", means,
                         steps_per_epoch * (epoch + 1))
            sel = means[cfg.select_metric]
            sel = sel[0] if isinstance(sel, list) else sel
            if sel < best_metric:
                best_metric, best_epoch = sel, epoch
            log_fn(f"avg_test_scalars {means}")
            log_fn(f"MAX epoch {best_epoch} total test "
                   f"{cfg.select_metric} = {best_metric:.5f}")
        log_fn(f"epoch {epoch} took {time.time() - t_epoch:.1f}s")

    return {"best_epoch": best_epoch, "best_metric": best_metric,
            "state": state}


def measure_performance(model: torch.nn.Module, *, height: int = 512,
                        width: int = 960, reps: int = 50,
                        warmup: int = 5) -> float:
    """Mean eval-forward latency in ms on the card (the reference's
    ``train_sceneflow.py:254-275`` harness): a seeded pair at ``height`` x
    ``width`` (multiples of 32), ``warmup`` calls, then CUDA events around
    ``reps`` calls, under ``torch.inference_mode``. The model must lie on
    a CUDA device."""
    device = model_device(model)
    if device.type != "cuda":
        raise ValueError("measure_performance times the card; the model "
                         f"lies on {device}")
    gen = torch.Generator().manual_seed(0)
    left = torch.randn((1, height, width, 3), generator=gen).to(device)
    right = torch.randn((1, height, width, 3), generator=gen).to(device)
    model.eval()
    with torch.inference_mode():
        for _ in range(warmup):
            model(left, right)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            model(left, right)
        end.record()
        torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
