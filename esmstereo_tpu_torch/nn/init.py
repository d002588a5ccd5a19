"""Weight initialisers of the reference network, on PyTorch weight layouts.

Counterpart of ``esmstereo_tpu/nn/init.py`` (and the deconv rule of
``esmstereo_tpu/nn/blocks.py:136-140``). The JAX package stores kernels as
``(*k, in, out)``; here a conv weight is ``(out, in/groups, *k)`` and a
transposed-conv weight ``(in, out, *k)``, so the fans are read from other
axes. The rules are the same:

  * ``msra``: Normal(0, sqrt(2/n)), ``n = prod(kernel) * out_channels``
    (the reference's ``SubModule.weight_init``);
  * ``torch``: U(-b, b), ``b = 1/sqrt(fan_in)``, ``fan_in = in/groups *
    prod(kernel)`` (torch's Conv default, kaiming_uniform with a=sqrt(5));
  * deconv: U(-b, b) with ``fan_in = out_channels * prod(kernel)``;
  * bias: U(-b, b) with the layer's ``fan_in``.

Values are drawn on the CPU from a ``torch.Generator`` and copied to the
parameter's device, so one seed gives the same weights on every device.
JAX's ``jax.random`` gives other numbers for the same seed: tests carry
weights across with ``models.convert_jax`` instead.
"""

from __future__ import annotations

import math

import torch


def _fill(param: torch.Tensor, values: torch.Tensor) -> None:
    if param.device.type == "meta":
        return
    with torch.no_grad():
        param.copy_(values)


def msra_out_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Conv weight ``(out, in/groups, *k)`` ~ Normal(0, sqrt(2/(prod(k)*out)))."""
    n = math.prod(w.shape[2:]) * w.shape[0]
    std = math.sqrt(2.0 / n)
    _fill(w, torch.randn(w.shape, generator=gen) * std)


def uniform_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    _fill(w, (torch.rand(w.shape, generator=gen) * 2.0 - 1.0) * bound)


def conv_fan_in(w: torch.Tensor) -> int:
    """Fan-in of a conv weight ``(out, in/groups, *k)``."""
    return w.shape[1] * math.prod(w.shape[2:])


def deconv_fan_in(w: torch.Tensor) -> int:
    """torch's fan-in of a transposed-conv weight ``(in, out, *k)``."""
    return w.shape[1] * math.prod(w.shape[2:])


def torch_conv_(w: torch.Tensor, gen: torch.Generator) -> None:
    """torch Conv default: U(-b, b), b = 1/sqrt(in/groups * prod(k))."""
    uniform_(w, conv_fan_in(w), gen)


def init_model_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Re-draw every parameter of ``model`` that has an init rule, in module
    order, from ``gen``. Modules with a rule define
    ``reset_parameters_from(gen)``; BatchNorm and LayerNorm weights keep their
    deterministic defaults (1 and 0)."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters_from", None)
        if reset is not None:
            reset(gen)
