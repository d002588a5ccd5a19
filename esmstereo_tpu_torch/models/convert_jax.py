"""Weight bridge: JAX variables -> the port's ``state_dict``.

``state_dict_from_jax(variables)`` takes the ``{"params", "batch_stats"}``
tree of ``esmstereo_tpu.models.ESMStereo`` as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``) and returns the ``state_dict`` of
``models.esmstereo.ESMStereo``. The port names its modules after the flax
paths, so the bridge is a walk over the tree plus the layout transforms of
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
"""

from __future__ import annotations

import numpy as np
import torch

_CONV_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_DECONV_AXES = {4: (2, 3, 0, 1), 5: (3, 4, 0, 1, 2)}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
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


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The port's ``ESMStereo`` ``state_dict`` from the variables of the JAX
    ``ESMStereo`` in its default (L) configuration."""
    from esmstereo_tpu_torch.models.esmstereo import ESMStereo

    sd = convert_tree(variables)
    model = ESMStereo(device="meta")
    check_against(sd, model.state_dict())
    return sd
