"""Weight bridge: JAX variables -> the port's ``state_dict``.

``state_dict_from_jax(variables, config)`` takes the ``{"params",
"batch_stats"}`` tree of ``esmstereo_tpu.models.ESMStereo`` (or of
``ESMStereoConfidence``, whose ``stereo`` and ``confidence_net`` subtrees it
recognises) as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``) and returns the ``state_dict`` of
``models.esmstereo.ESMStereo(config)`` (or of
``models.confidence.ESMStereoConfidence(config)``). The port names
its modules after the flax paths, so the bridge is a walk over the tree
plus the layout transforms of
``esmstereo_tpu/models/convert_reference.py:13-18``, inverted:

  * conv kernel ``(*k, I, O)`` at ``<path>/Conv_0/kernel`` -> ``<path>.weight``
    ``(O, I, *k)``; its bias -> ``<path>.bias``;
  * transposed-conv kernel ``(*k, I, O)`` at ``<path>/kernel`` ->
    ``<path>.weight`` ``(I, O, *k)``. The JAX package flips the kernel when
    it runs it (``nn/blocks.py:147``); torch's transposed conv takes it
    unflipped;
  * BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
    ``weight``/``bias`` and ``running_mean``/``running_var`` (plus a zero
    ``num_batches_tracked``);
  * ``ChannelLayerNorm``'s ``weight`` as it is.

Any leaf that matches no rule, and any key the port's model has that the
tree does not give (or the other way round), raises ``KeyError``.

``optimizer_state_from_jax(opt_state, state)`` carries an ``optax.adamw``
or ``optax.adam`` state (its ``ScaleByAdamState``: ``count``, ``mu``,
``nu``, trees of the ``params`` layout) into a ``train.state.TrainState``:
``mu`` and ``nu`` through the same layout transforms into each
parameter's ``exp_avg`` and ``exp_avg_sq``, ``count`` into the optimizer's
``step``, the train state's step and the LR schedule, so that a JAX run
resumes in the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_CONV_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_DECONV_AXES = {4: (2, 3, 0, 1), 5: (3, 4, 0, 1, 2)}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _param_entry(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mod, leaf = path
    if mod and mod[-1] == "Conv_0":
        mod = mod[:-1]
        if leaf == "kernel" and arr.ndim in _CONV_AXES:
            return ".".join(mod + ["weight"]), arr.transpose(_CONV_AXES[arr.ndim])
        if leaf == "bias" and arr.ndim == 1:
            return ".".join(mod + ["bias"]), arr
    elif leaf == "kernel" and arr.ndim in _DECONV_AXES:
        return ".".join(mod + ["weight"]), arr.transpose(_DECONV_AXES[arr.ndim])
    elif leaf in ("scale", "weight") and arr.ndim == 1:
        return ".".join(mod + ["weight"]), arr
    elif leaf == "bias" and arr.ndim == 1:
        return ".".join(mod + ["bias"]), arr
    raise KeyError(f"no mapping for params/{'/'.join(path)} {arr.shape}")


def convert_tree(variables: dict) -> dict[str, torch.Tensor]:
    """Map every leaf of a JAX variable tree (any module's subtree) to a
    ``state_dict`` entry; raises ``KeyError`` on a leaf no rule covers."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables.get("params", {})):
        key, val = _param_entry(path, arr)
        sd[key] = torch.tensor(np.asarray(val, np.float32))
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names or arr.ndim != 1:
            raise KeyError(f"no mapping for batch_stats/{'/'.join(path)}")
        sd[".".join(mod + [names[leaf]])] = torch.tensor(
            np.asarray(arr, np.float32))
        sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def check_against(sd: dict, expected: dict) -> None:
    """Raise ``KeyError`` unless ``sd`` has exactly the keys and shapes of
    ``expected`` (a module's ``state_dict``)."""
    missing = sorted(set(expected) - set(sd))
    extra = sorted(set(sd) - set(expected))
    if missing or extra:
        raise KeyError(f"weight bridge: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, "
                       f"unmapped {extra[:8]}{'...' if len(extra) > 8 else ''}")
    bad = [k for k in expected if tuple(sd[k].shape) != tuple(expected[k].shape)]
    if bad:
        raise KeyError("weight bridge: shape mismatch at " + ", ".join(
            f"{k} {tuple(sd[k].shape)} vs {tuple(expected[k].shape)}"
            for k in bad[:8]))


def state_dict_from_jax(variables: dict, config=None
                        ) -> dict[str, torch.Tensor]:
    """The port's ``ESMStereo(config)`` ``state_dict`` from the variables of
    the JAX ``ESMStereo`` in the same configuration (the default, L gwc,
    when ``config`` is None), checked against that config's model. A tree
    with a ``confidence_net`` subtree is the JAX ``ESMStereoConfidence``'s,
    checked against the port's ``ESMStereoConfidence(config)`` (the
    default, S gwc, when ``config`` is None)."""
    from esmstereo_tpu_torch.models.confidence import (CONFIDENCE_CONFIG,
                                                       ESMStereoConfidence)
    from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,
                                                      ESMStereoConfig)

    sd = convert_tree(variables)
    if "confidence_net" in variables.get("params", {}):
        model = ESMStereoConfidence(config or CONFIDENCE_CONFIG,
                                    device="meta")
    else:
        model = ESMStereo(config or ESMStereoConfig(), device="meta")
    check_against(sd, model.state_dict())
    return sd


def _adam_moments(opt_state):
    """``(count, mu, nu)`` of the scale-by-Adam state inside an optax
    state (a chain's tuple, any nesting), or of a ``{"count", "mu",
    "nu"}`` dict."""
    if isinstance(opt_state, Mapping) and {"count", "mu", "nu"} <= set(
            opt_state):
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            try:
                return _adam_moments(sub)
            except KeyError:
                pass
    raise KeyError("no scale-by-Adam state (count, mu, nu) in the optimizer "
                   "state")


def optimizer_state_from_jax(opt_state, state) -> None:
    """Load ``opt_state`` (an ``optax.adamw`` / ``optax.adam`` state as
    numpy, e.g. ``jax.tree.map(np.asarray, train_state.opt_state)``) into
    ``state`` (a ``train.state.TrainState`` whose optimizer is
    ``make_optimizer``'s), in place. Raises ``KeyError`` on a leaf no rule
    covers, or unless the moments give exactly the model's parameters and
    shapes."""
    count, mu, nu = _adam_moments(opt_state)
    count = int(np.asarray(count))
    params = dict(state.model.named_parameters())
    moments = []
    for tree in (mu, nu):
        sd = {}
        for path, arr in _leaves(tree):
            key, val = _param_entry(path, arr)
            sd[key] = np.asarray(val, np.float32)
        check_against(sd, params)
        moments.append(sd)
    opt = state.optimizer
    for name, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(moments[0][name], device=p.device),
            "exp_avg_sq": torch.tensor(moments[1][name], device=p.device)}
    state.step = count
    sched = state.scheduler
    sched.last_epoch = count
    for group, base, fn in zip(opt.param_groups, sched.base_lrs,
                               sched.lr_lambdas):
        group["lr"] = base * fn(count)
    sched._last_lr = [group["lr"] for group in opt.param_groups]
