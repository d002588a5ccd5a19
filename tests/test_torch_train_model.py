"""PyTorch port: the training mode of ESMStereo against the JAX package's
``train=True``.

ESMStereo-S (cv16, mobilenetv2_100) at 64x128, batch 1: one JAX program
(``jax.value_and_grad`` of ``model_loss_train`` with ``fix_cv16``, so both
scales are supervised) gives the outputs of every scale, the gradients
and the updated ``batch_stats``; the port's training forward and backward
on the same weights (``state_dict_from_jax``) and batch must match them:
the outputs within 1e-4 relative, each parameter's gradient within 1e-4 of
its max|g|, the running statistics within 1e-4 under flax's
biased-variance rule (torch's own unbiased rule misses by far more there,
and is shown to). ESMStereo-L's full-res training output on at least 99%
of the pixels (cv4's top-2 regression flips bins at knife-edge pixels,
ROADMAP's rules). The optax-state bridge on the same S variables. 64x128 is the smallest size at which every BatchNorm
sees more than one value per channel (S's hourglass bottom: 2 at batch 1).

S's JAX reference runs in float64 (``jax.enable_x64``): batch statistics
make the training forward far less well conditioned than the eval one,
and JAX's own fp32 run of S lies 1.2e-4 (these weights) to 2.8e-4
(init-rule weights) of max|disparity| from its float64 run, where the
port's fp32 run lies 2.5e-5 to 5.5e-5 from it. The port's fp32 run is held
to the float64 reference; its gradients are held in float64 (the same
function). L's pixel-share bound is held against JAX in fp32 (a float64
run of L costs 14 s more on the CPU).

Variables are seeded numpy values on the JAX ``eval_shape`` tree; each JAX
program compiles once, with LLVM's expensive passes off.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402
from torch import nn  # noqa: E402

from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models.losses import (  # noqa: E402
    disparity_masks as jax_masks, model_loss_train as jax_loss)
from esmstereo_tpu.train import schedule as jschedule  # noqa: E402
from esmstereo_tpu_torch.data.synthetic import make_scene_batch  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import (  # noqa: E402
    convert_tree, optimizer_state_from_jax, state_dict_from_jax)
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.models.losses import (disparity_masks,  # noqa: E402
                                               model_loss_train)
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import reset_launches, wrappers  # noqa: E402
from esmstereo_tpu_torch.train import schedule  # noqa: E402
from esmstereo_tpu_torch.train.state import create_train_state  # noqa: E402
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
S = dict(cv_scale=16, backbone="mobilenetv2_100")
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def _batch(seed: int, size: int) -> dict:
    return make_scene_batch(np.random.default_rng(seed), size, H, W)


def _close(got, want, tol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _gts(batch: dict) -> list:
    return [batch["disparity"], *batch["disparity_low"]]


def _f64(*trees):
    """float64 copies of numpy trees, for a JAX program under
    ``jax.enable_x64``."""
    return jax.tree.map(lambda x: np.asarray(x, np.float64), trees)


@functools.cache
def _jax_s():
    """The JAX S model's training step pieces on seeded variables: (loss,
    outputs, gradients, updated batch_stats), and the inputs."""
    rng = np.random.default_rng(15)
    model = JaxESMStereo(JaxConfig(**S))
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    batch = _batch(3, 1)

    def loss_fn(params, stats, left, right, gts):
        outs, mutated = model.apply(
            {"params": params, "batch_stats": stats}, left, right,
            train=True, mutable=["batch_stats"])
        loss = jax_loss(outs, gts, jax_masks(gts, 192), 16, fix_cv16=True)
        return loss, (outs, mutated["batch_stats"])

    with jax.enable_x64(True):
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                       compiler_options=FAST_COMPILE)
        (loss, (outs, stats)), grads = step(
            *_f64(variables["params"], variables["batch_stats"],
                  batch["left"], batch["right"], _gts(batch)))
        as_np = functools.partial(jax.tree.map, np.asarray)
        return (variables, batch, float(loss), as_np(outs), as_np(grads),
                as_np(stats))


def _port_s_step(bn_rule: bool = True, dtype=torch.float32):
    """The port's S on the JAX variables: one training forward and
    backward in ``dtype``; returns (model, loss, outputs). With
    ``bn_rule`` False every BatchNorm runs torch's own (unbiased)
    running-variance rule."""
    variables, batch, *_ = _jax_s()
    config = ESMStereoConfig(**S)
    port = ESMStereo(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    port.to(dtype)
    if not bn_rule:
        for m in port.modules():
            if isinstance(m, blocks.BatchNorm2d):
                m.__class__ = nn.BatchNorm2d
            elif isinstance(m, blocks.BatchNorm3d):
                m.__class__ = nn.BatchNorm3d
    port.train()
    gts = [torch.from_numpy(g).to(dtype) for g in _gts(batch)]
    outs = port(torch.from_numpy(batch["left"]).to(dtype),
                torch.from_numpy(batch["right"]).to(dtype))
    loss = model_loss_train(outs, gts, disparity_masks(gts, 192), 16,
                            fix_cv16=True)
    loss.backward()
    return port, loss, outs


@functools.cache
def _port_s(dtype=torch.float32):
    return _port_s_step(dtype=dtype)


def _stats_error(port, stats) -> dict:
    """Per buffer: max|port - JAX| / max(1, max|JAX|) of the running
    statistics."""
    want = convert_tree({"batch_stats": jax.tree.map(
        lambda x: x.astype(np.float32), stats)})
    got = port.state_dict()
    return {k: float(np.abs(got[k].numpy() - v.numpy()).max()
                     / max(1.0, float(v.abs().max())))
            for k, v in want.items() if not k.endswith("num_batches_tracked")}


def test_s_train_outputs_match_jax():
    """Every scale of S's training output (full-res, then 1/4) and the
    loss within 1e-4 relative of max(1, max|JAX|); no kernel wrapper
    counts a launch."""
    reset_launches()
    _, _, jloss, jouts, _, _ = _jax_s()
    port, loss, outs = _port_s()
    assert len(outs) == len(jouts) == 2
    for got, want, shape in zip(outs, jouts, ((1, H, W), (1, H // 4, W // 4))):
        got = got.detach().numpy()
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        rel = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
        assert rel < 1e-4
    assert abs(float(loss.detach()) - jloss) <= 1e-4 * max(1.0, abs(jloss))
    assert all(fn.launches == 0 for fn in wrappers().values())


def test_s_train_gradients_match_jax():
    """Each parameter's gradient, the port's backward pass in float64,
    within 1e-4 of its max|g| against ``jax.value_and_grad`` in float64;
    where JAX's is all zero (the /32 stage, which cv16 does not read) the
    port's is None or zero. A gradient that is zero by construction but
    for rounding (the shift of a BatchNorm whose output only feeds a
    training-mode BatchNorm, which subtracts the batch mean: 1e-14 here)
    has no scale of its own: each tensor's max|g| is floored at 1e-9 of
    the largest tensor's. (In fp32 the gradients of the BatchNorm
    shifts downstream of the volume move by up to 2e-4 of their max|g|
    from the float64 ones: the training forward's conditioning, not the
    port's function.)"""
    _, _, _, _, grads, _ = _jax_s()
    port, _, _ = _port_s(torch.float64)
    want = convert_tree({"params": grads})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    floor = 1e-9 * max(float(w.abs().max()) for w in want.values())
    bad = {}
    for name, p in params.items():
        w = np.asarray(want[name].numpy(), np.float64)
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        peak = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        if err > 1e-4 * max(peak, floor):
            bad[name] = (err, peak)
    assert floor > 0.0 and not bad, bad
    unread = [n for n, p in params.items() if p.grad is None]
    assert unread and all(n.startswith("feature.blocks_5_") for n in unread)


def test_s_train_batch_stats_match_jax_flax_rule():
    """The running statistics after one training forward within 1e-4 of
    max(1, max|JAX|) per buffer (flax: the batch's biased variance, torch
    momentum 0.1 as flax's 0.9). With torch's own rule (the unbiased
    variance) the same run misses by more than 1e-3 on the maps with few
    values per channel."""
    _, _, _, _, _, stats = _jax_s()
    errs = _stats_error(_port_s()[0], stats)
    assert len(errs) == 2 * sum(isinstance(m, nn.modules.batchnorm._BatchNorm)
                                for m in _port_s()[0].modules())
    assert max(errs.values()) < 1e-4, max(errs.items(), key=lambda kv: kv[1])
    torch_rule = _stats_error(_port_s_step(bn_rule=False)[0], stats)
    assert max(torch_rule.values()) > 1e-3


def test_l_train_full_res_output_matches_jax():
    """ESMStereo-L's training forward against JAX's ``train=True``: both
    scales' shapes, the full-res disparity within 1e-4 relative of max(1,
    max|JAX|) on at least 99% of the pixels (top-2 flips) and the 1/2
    output the same, and the running statistics within 1e-4 where the
    flips do not reach (the hourglass and everything before it)."""
    rng = np.random.default_rng(4)
    model = JaxESMStereo(JaxConfig())
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    batch = _batch(5, 1)
    outs, mutated = jax.jit(
        lambda v, l, r: model.apply(v, l, r, train=True,
                                    mutable=["batch_stats"]),
        compiler_options=FAST_COMPILE)(variables, batch["left"],
                                       batch["right"])
    outs = [np.asarray(o) for o in outs]
    stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    port = ESMStereo(device="cpu")
    port.load_state_dict(state_dict_from_jax(variables))
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(batch["left"]),
                   torch.from_numpy(batch["right"]))
    assert len(got) == len(outs) == 2
    for g, w, shape in zip(got, outs, ((1, H, W), (1, H // 2, W // 2))):
        g, w = g.numpy(), w
        assert g.shape == w.shape == shape and np.isfinite(g).all()
        rel = np.abs(g - w) / max(1.0, float(np.abs(w).max()))
        assert (rel < 1e-4).mean() >= 0.99
    errs = _stats_error(port, stats)
    early = {k: e for k, e in errs.items()
             if not k.startswith("upsample_module")}
    assert len(early) > 100 and max(early.values()) < 1e-4


# --- the optax-state bridge, on the same S variables --------------------------

@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optax_state_bridge(name):
    """A JAX run's step 1 (``optax``), carried into the port by
    ``optimizer_state_from_jax`` with its parameters, then step 2 in the
    port equals JAX's step 2 within 1e-6 on every parameter, and the
    port's step, optimizer step and LR follow the count. A tree that
    leaves a parameter out raises ``KeyError``."""
    variables = _jax_s()[0]
    rng = np.random.default_rng(3)
    draw = functools.partial(jax.tree.map, lambda x: rng.normal(
        0, 1, x.shape).astype(np.float32))
    g1, g2 = draw(variables["params"]), draw(variables["params"])
    jfn = jschedule.lr_schedule_fn(1e-3, "1:2", 1)
    tx = (optax.adamw(jfn, b1=0.9, b2=0.999, weight_decay=0.01)
          if name == "adamw" else optax.adam(jfn, b1=0.9, b2=0.999))

    @jax.jit
    def two_steps(p0, g1, g2):
        """Steps 1 and 2 on the tree flattened into one vector (Adam and
        AdamW without a mask are elementwise: the same numbers, and one
        leaf to trace instead of 400)."""
        upd, st = tx.update(g1, tx.init(p0), p0)
        p1 = optax.apply_updates(p0, upd)
        upd, _ = tx.update(g2, st, p1)
        return p1, st, optax.apply_updates(p1, upd)

    leaves, treedef = jax.tree.flatten(variables["params"])
    ends = np.cumsum([leaf.size for leaf in leaves])[:-1]

    def unravel(x):
        return treedef.unflatten([
            part.reshape(leaf.shape)
            for part, leaf in zip(np.split(np.asarray(x), ends), leaves)])

    p1, st, p2 = two_steps(*(
        np.concatenate([leaf.ravel() for leaf in jax.tree.leaves(t)])
        for t in (variables["params"], g1, g2)))
    p1, p2 = unravel(p1), unravel(p2)
    st = jax.tree.map(lambda x: unravel(x) if x.ndim else x, st)

    config = ESMStereoConfig(**S)
    model = ESMStereo(config, device="cpu")
    as_np = functools.partial(jax.tree.map, np.asarray)
    model.load_state_dict(state_dict_from_jax(
        {"params": as_np(p1), "batch_stats": variables["batch_stats"]},
        config))
    state = create_train_state(model, name,
                               schedule.lr_schedule_fn(1e-3, "1:2", 1))
    optimizer_state_from_jax(as_np(st), state)
    assert state.step == 1
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    grads = convert_tree({"params": as_np(g2)})
    for key, p in model.named_parameters():
        p.grad = grads[key]
    state.optimizer.step()
    want = convert_tree({"params": as_np(p2)})
    for key, p in model.named_parameters():
        _close(p.detach(), want[key], 1e-6)
    adam = st[0]
    short = dict(adam.mu)
    short.pop("desc")
    with pytest.raises(KeyError):
        optimizer_state_from_jax({"count": adam.count, "mu": short,
                                  "nu": adam.nu}, state)
