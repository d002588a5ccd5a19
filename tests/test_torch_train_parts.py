"""PyTorch port: the training modules around the model against the JAX
package: the losses, the metrics, the meters, the ``lrepochs`` schedule,
AdamW / Adam against ``optax``, checkpoints, synthetic data and the
loader, ``run_training`` and the registry; and the kernel wrappers'
refusal of autograd. (The optax-state bridge is in
``test_torch_train_model.py``, on that file's S variables.)

Small arrays from ``np.random.default_rng``, JAX run eagerly or in one
small jit; the checkpoints and ``run_training`` use ESMStereo-S at 64x128
on the CPU. Each comparison states its tolerance.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from esmstereo_tpu import models as jmodels  # noqa: E402
from esmstereo_tpu.data import loader as jloader  # noqa: E402
from esmstereo_tpu.data import synthetic as jsynthetic  # noqa: E402
from esmstereo_tpu.models import losses as jlosses  # noqa: E402
from esmstereo_tpu.train import schedule as jschedule  # noqa: E402
from esmstereo_tpu.utils import meters as jmeters  # noqa: E402
from esmstereo_tpu.utils import metrics as jmetrics  # noqa: E402
from esmstereo_tpu_torch import models  # noqa: E402
from esmstereo_tpu_torch.data import loader, synthetic  # noqa: E402
from esmstereo_tpu_torch.models import losses  # noqa: E402
from esmstereo_tpu_torch.models.confidence import (  # noqa: E402
    ESMStereoConfidence)
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.ops.kernels import (refuse_autograd,  # noqa: E402
                                             reset_launches, wrappers)
from esmstereo_tpu_torch.train import checkpoints, schedule  # noqa: E402
from esmstereo_tpu_torch.train.loop import (TrainLoopConfig,  # noqa: E402
                                            run_training)
from esmstereo_tpu_torch.train.state import (count_params,  # noqa: E402
                                             create_train_state,
                                             lr_scheduler, make_optimizer)
from esmstereo_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                            make_infer_fn, make_train_step)
from esmstereo_tpu_torch.utils import meters, metrics  # noqa: E402

torch.set_num_threads(2)

S = ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")


def _close(got, want, tol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _pyramid(rng, b: int = 2, h: int = 16, w: int = 32) -> list:
    """A full-res GT and its /2 ... /16 maps, with invalid (0 and >= 192)
    pixels."""
    gt = rng.uniform(-20, 220, (b, h, w)).astype(np.float32)
    return [gt] + [gt[:, ::r, ::r] for r in (2, 4, 8, 16)]


# --- losses ------------------------------------------------------------------

@pytest.mark.parametrize("cv_scale,fix_cv16", [
    (4, False), (8, False), (16, False), (16, True)])
def test_loss_matches_jax(rng, cv_scale, fix_cv16):
    """``model_loss_train`` at each scale's outputs (cv16 with and without
    ``fix_cv16``) and ``model_loss_test`` against JAX within 1e-6
    relative; with every mask empty both are 0, not NaN."""
    gts = _pyramid(rng)
    n_out = {4: 2, 8: 3, 16: 2}[cv_scale]
    scale_of = {4: (0, 1), 8: (0, 1, 2), 16: (0, 2)}[cv_scale]
    ests = [gts[i] + rng.normal(0, 3, gts[i].shape).astype(np.float32)
            for i in scale_of[:n_out]]
    for gt_set in (gts, [np.zeros_like(g) for g in gts]):
        want = jlosses.model_loss_train(
            [jnp.asarray(e) for e in ests], [jnp.asarray(g) for g in gt_set],
            jlosses.disparity_masks([jnp.asarray(g) for g in gt_set], 192),
            cv_scale, fix_cv16=fix_cv16)
        tg = [torch.from_numpy(g) for g in gt_set]
        te = [torch.from_numpy(e) for e in ests]
        got = losses.model_loss_train(te, tg, losses.disparity_masks(tg, 192),
                                      cv_scale, fix_cv16=fix_cv16)
        _close(got, want, 1e-6)
        assert np.isfinite(float(got))
        masks = losses.disparity_masks(tg[:1], 192)
        _close(losses.model_loss_test(te, tg[:1], masks),
               jlosses.model_loss_test(
                   [jnp.asarray(ests[0])], [jnp.asarray(gt_set[0])],
                   [jnp.asarray(masks[0].numpy())]), 1e-6)
    assert float(got) == 0.0


def test_smooth_l1_and_masked_mean_match_jax(rng):
    x = rng.normal(0, 2, (3, 7)).astype(np.float32)
    mask = rng.random((3, 7)) > 0.5
    _close(losses.smooth_l1(torch.from_numpy(x)), jlosses.smooth_l1(x), 1e-7)
    _close(losses.masked_mean(torch.from_numpy(x), torch.from_numpy(mask)),
           jlosses.masked_mean(jnp.asarray(x), jnp.asarray(mask)), 1e-6)


# --- metrics -----------------------------------------------------------------

def test_metrics_match_jax(rng):
    """``eval_metrics`` and ``d1_metric_thres`` against JAX within 1e-6:
    a batch with one image skipped (mask under 10% of its positive GT),
    then one with every image skipped (each metric 0)."""
    est = rng.uniform(0, 60, (3, 16, 32)).astype(np.float32)
    gt = rng.uniform(1, 60, (3, 16, 32)).astype(np.float32)
    mask = rng.random((3, 16, 32)) > 0.3
    mask[1] = False
    mask[1, 0, :5] = True                      # 5 of 512: skipped
    for m in (mask, np.zeros_like(mask)):
        want = jmetrics.eval_metrics(jnp.asarray(est), jnp.asarray(gt),
                                     jnp.asarray(m))
        args = (torch.from_numpy(est), torch.from_numpy(gt),
                torch.from_numpy(m))
        got = metrics.eval_metrics(*args)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 1e-6)
        _close(metrics.d1_metric_thres(*args, 1.5), jmetrics.d1_metric_thres(
            jnp.asarray(est), jnp.asarray(gt), jnp.asarray(m), 1.5), 1e-6)
    assert all(float(v) == 0.0 for v in got.values())
    one = metrics.epe_metric(*(t[1:2] for t in (torch.from_numpy(est),
                                                torch.from_numpy(gt),
                                                torch.from_numpy(mask))))
    assert float(one) == 0.0


def test_meters_match_jax():
    """``AverageMeter``, ``AverageMeterDict`` and ``save_scalars`` (any
    logger with ``add_scalar``; None logs nothing) as the JAX ones."""

    class Log:
        def __init__(self):
            self.rows = []

        def add_scalar(self, *row):
            self.rows.append(row)

    updates = [{"loss": 1.5, "EPE": [2.0, 4.0]}, {"loss": 0.5,
                                                   "EPE": [1.0, 3.0]}]
    got, want = meters.AverageMeterDict(), jmeters.AverageMeterDict()
    for u in updates:
        got.update(u)
        want.update(u)
    assert got.mean() == want.mean() == {"loss": 1.0, "EPE": [1.5, 3.5]}
    a, b = meters.AverageMeter(), jmeters.AverageMeter()
    for x, n in ((1.0, 2), (4.0, 1)):
        a.update(x, n)
        b.update(x, n)
    assert a.avg == b.avg == 2.0
    logs = Log(), Log()
    meters.save_scalars(logs[0], "train", got.mean(), 7)
    jmeters.save_scalars(logs[1], "train", want.mean(), 7)
    assert logs[0].rows == logs[1].rows and len(logs[0].rows) == 3
    meters.save_scalars(None, "train", got.mean(), 7)


# --- the schedule and the optimizers ------------------------------------------

def test_lr_schedule_matches_jax():
    """The step -> LR function against ``lr_schedule_fn`` on both sides of
    every epoch boundary of the SceneFlow and KITTI specs (relative
    1e-6: JAX computes in fp32), ``lr_for_epoch`` as JAX's, and a
    ``LambdaLR`` over ``make_optimizer`` gives update i the LR of step i
    (optax's count: step 0 takes ``lr_fn(0)``)."""
    for spec, spe in (("20,32,40,48,56:2", 7), ("300:10", 3)):
        epochs, _ = schedule.parse_lrepochs(spec)
        assert (epochs, _) == jschedule.parse_lrepochs(spec)
        fn = schedule.lr_schedule_fn(1e-3, spec, spe)
        jfn = jax.jit(jschedule.lr_schedule_fn(1e-3, spec, spe))
        for e in [0, *epochs, epochs[-1] + 5]:
            for step in (e * spe - 1, e * spe, e * spe + 1):
                if step >= 0:
                    _close(fn(step) * 1e3, float(jfn(step)) * 1e3, 1e-6)
            assert schedule.lr_for_epoch(1e-3, e, spec) == \
                jschedule.lr_for_epoch(1e-3, e, spec)
    state = create_train_state(torch.nn.Linear(1, 1), "adam",
                               schedule.lr_schedule_fn(0.1, "1,2:10", 2))
    lrs = []
    for _ in range(5):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    assert lrs == pytest.approx([0.1, 0.1, 0.01, 0.01, 0.001])
    with pytest.raises(ValueError):
        make_optimizer("sgd", [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizer_matches_optax(rng, name):
    """AdamW (decay 0.01 on every tensor) and Adam fed the same gradients
    for 3 steps, under a schedule that decays after step 1, against
    ``optax.adamw`` / ``optax.adam`` within 1e-6."""
    spec, spe = "1,2:4", 1
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    jfn = jschedule.lr_schedule_fn(1e-2, spec, spe)
    tx = (optax.adamw(jfn, b1=0.9, b2=0.999, weight_decay=0.01)
          if name == "adamw" else optax.adam(jfn, b1=0.9, b2=0.999))
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(name, tp.values())
    sched = lr_scheduler(opt, schedule.lr_schedule_fn(1e-2, spec, spe))
    for _ in range(3):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for k in params:
            _close(tp[k].detach(), jp[k], 1e-6)


# --- checkpoints, data, the loop ------------------------------------------------

def _batch(seed: int, b: int = 1) -> dict:
    return synthetic.make_scene_batch(np.random.default_rng(seed), b, 64, 128)


def test_checkpoint_resume_and_warm_start(tmp_path, capsys):
    """After one train step, ``save_checkpoint`` -> ``restore_checkpoint``
    into a fresh state gives the same parameters, statistics, optimizer
    state, schedule and step, and the next epoch; ``latest_checkpoint``
    takes the highest epoch. ``warm_start`` from S-gwc into S-norm loads
    every tensor whose name and shape match (not the semantic convs,
    whose widths differ), prints the counts and leaves the optimizer
    fresh."""
    model = ESMStereo(S, device="cpu", seed=1)
    state = create_train_state(model, "adamw",
                               schedule.lr_schedule_fn(1e-3, "1:2", 1))
    make_train_step(model)(state, _batch(0))
    for epoch in (0, 2):
        checkpoints.save_checkpoint(str(tmp_path), state, epoch)
    path = checkpoints.latest_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "checkpoint_000002")
    assert checkpoints.latest_checkpoint(str(tmp_path / "none")) is None

    fresh = create_train_state(ESMStereo(S, device="cpu", seed=2), "adamw",
                               schedule.lr_schedule_fn(1e-3, "1:2", 1))
    fresh, next_epoch = checkpoints.restore_checkpoint(path, fresh)
    assert next_epoch == 3 and fresh.step == 1
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, entry in sa["state"].items():
        for k, v in entry.items():
            assert torch.equal(v, sb["state"][i][k])
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()

    norm = ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100",
                           cost_volume="norm_correlation")
    target = create_train_state(ESMStereo(norm, device="cpu", seed=3),
                                "adam", lambda step: 1e-3)
    before = dict(target.model.state_dict())
    capsys.readouterr()
    checkpoints.warm_start(path, target)
    out = capsys.readouterr().out
    src = model.state_dict()
    names = [k for k, _ in target.model.named_parameters()]
    hits = [k for k in names
            if k in src and src[k].shape == before[k].shape]
    assert 0 < len(hits) < len(names) and "semantic_1.weight" not in hits
    assert f"warm_start: params: matched {len(hits)}/{len(names)}" in out
    assert "warm_start: batch_stats: matched" in out
    after = target.model.state_dict()
    assert torch.equal(after["desc.weight"], src["desc.weight"])
    assert torch.equal(after["semantic_1.weight"],
                       before["semantic_1.weight"])
    assert not target.optimizer.state


def test_synthetic_data_and_loader_match_jax():
    """The port's ``make_scene_batch`` and ``make_batch`` equal JAX's bit
    for bit from the same rng; the loader gives JAX's loader's batches
    (per-sample rngs keyed by seed, epoch and index) with 1 or 3 workers,
    ``len`` as JAX's, and another epoch another draw."""
    for fn in ("make_scene_batch", "make_batch"):
        got = getattr(synthetic, fn)(np.random.default_rng(5), 2, 32, 64)
        want = getattr(jsynthetic, fn)(np.random.default_rng(5), 2, 32, 64)
        for k in ("left", "right", "disparity"):
            assert np.array_equal(got[k], want[k])
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["disparity_low"], want["disparity_low"]))
    ds = synthetic.SceneDataset(5, 32, 64)
    want = list(jloader.DataLoader(ds, 2, num_workers=2, seed=4))
    for workers in (1, 3):
        dl = loader.DataLoader(ds, 2, num_workers=workers, seed=4)
        got = list(dl)
        assert len(dl) == len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert np.array_equal(a["left"], b["left"])
            assert all(np.array_equal(x, y) for x, y in
                       zip(a["disparity_low"], b["disparity_low"]))
    dl.set_epoch(1)
    assert not np.array_equal(next(iter(dl))["left"], want[0]["left"])
    assert len(loader.DataLoader(ds, 2, drop_last=False)) == 3


def test_run_training_tiny(tmp_path):
    """``run_training`` on S at 64x128, 2 epochs of 2 batches (a loader of
    3 capped by ``max_batches_per_epoch``) on the CPU: finite logged
    losses, a checkpoint each epoch, the full-test evaluation tracked, the
    LR halved at epoch 1 (step 2), no kernel launched; then a resume
    finds the last checkpoint and has no epoch left to run. The eval and
    infer steps give the full-res disparity."""
    reset_launches()
    model = ESMStereo(S, device="cpu", seed=4)
    train = loader.DataLoader(synthetic.SceneDataset(3, 64, 128), 1,
                              num_workers=2)
    test = loader.DataLoader(synthetic.SceneDataset(1, 64, 128), 1, seed=9)
    cfg = TrainLoopConfig(epochs=2, lrepochs="1:2", logdir=str(tmp_path),
                          max_batches_per_epoch=2)
    lines = []
    out = run_training(model, cfg, train, test, log_fn=lines.append)
    iters = [line for line in lines if line.startswith("Epoch")]
    assert len(iters) == 4
    assert all(np.isfinite(float(line.split("loss ")[1].split("(")[0]))
               for line in iters)
    assert out["best_epoch"] in (0, 1) and np.isfinite(out["best_metric"])
    state = out["state"]
    assert state.step == 4
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000000",
                                            "checkpoint_000001"]
    assert all(fn.launches == 0 for fn in wrappers().values())
    again = run_training(model, dataclasses.replace(cfg, resume=True),
                         train, test, log_fn=lines.append)
    assert again["best_epoch"] == -1 and again["state"].step == 4
    assert any(line.startswith("resuming from") for line in lines)
    batch = _batch(1)
    metrics, disp = make_eval_step(model)(None, batch)
    assert disp.shape == (1, 64, 128) and set(metrics) == {
        "EPE", "D1", "Thres1", "Thres2", "Thres3", "loss"}
    assert torch.equal(make_infer_fn(model)(batch["left"], batch["right"]),
                       disp)


# --- the registry, the confidence model, the wrappers -----------------------

def test_registry():
    """``build_model`` names JAX's three models (``ESMStereo_trt`` an
    alias), on the device asked for, and raises ``KeyError`` on another;
    ``count_params`` gives S's count (``ACCURACY.json``)."""
    assert set(models.__models__) == set(jmodels.__models__)
    for name in ("ESMStereo", "ESMStereo_trt"):
        m = models.build_model(name, S, device="meta")
        assert type(m) is ESMStereo and count_params(m) == 1_772_986
    assert count_params(models.build_model("ESMStereo", device="meta")) \
        == 6_796_056
    conf = models.build_model("ESMStereo_confidence", device="meta")
    assert type(conf) is ESMStereoConfidence
    with pytest.raises(KeyError):
        models.build_model("GwcNet", device="meta")


def test_confidence_model_refuses_training():
    conf = ESMStereoConfidence(device="meta").train()
    with pytest.raises(NotImplementedError, match="two-phase"):
        conf(torch.zeros(1, 64, 128, 3, device="meta"),
             torch.zeros(1, 64, 128, 3, device="meta"))


def test_kernel_wrappers_refuse_autograd():
    """The check each wrapper runs before it launches a CUDA kernel: a
    tensor that requires grad under grad mode raises; under ``no_grad``
    or ``inference_mode``, or with no such tensor, it passes. (On the card
    ``chip_smoke.py`` [6] shows kernels B and C raise through it and the
    eval path still launches them.)"""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        refuse_autograd("stem_agg", torch.zeros(2), x)
    refuse_autograd("stem_agg", torch.zeros(2), x.detach())
    with torch.no_grad():
        refuse_autograd("stem_agg", x)
    with torch.inference_mode():
        refuse_autograd("stem_agg", x)
