"""Plain versions of the kernels' device activations (``csrc/activations.cuh``),
and the served bf16 activations (``csrc/activations_bf16.cu``).

``gelu_exact`` and ``gelu_tanh`` replace ``esmstereo_tpu/ops/pallas/
activations.py::gelu``; the A&S rational erf there exists only because
Mosaic has no ``erf``, and is not ported.

``activation_bf16`` computes a bf16 tensor's GELU (tanh or erf form),
SiLU, sigmoid or softmax over one dim as ``jax.nn`` writes it, rounding to
bf16 after every op, as XLA compiles ``jax.nn`` on a bf16 array with
``xla_allow_excess_precision=False`` (it expands ``lax.logistic`` into
``1 / (1 + exp(-x))``); torch's own functions evaluate in fp32 and round
once. The constants are rounded to bf16, as a weak-typed Python float
meeting a bf16 array is. It replaces no TPU kernel: the JAX package leaves
these ops to XLA, and the port needs one launch per activation to compute
XLA's per-op roundings (torch would split each into 4-9 elementwise
launches). On CUDA tensors it launches the kernel; on CPU tensors it runs
``activation_bf16_plain``, the same formulas as torch ops on bf16 tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return gelu_tanh(x) if approximate else gelu_exact(x)


# --- the served bf16 activations, op by op ------------------------------------

# the kernel's codes (csrc/activations_bf16.cu)
ACTIVATIONS = {"gelu_tanh": 0, "gelu_erf": 1, "silu": 2, "sigmoid": 3,
               "softmax": 4}


def _bf16(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


# jax.nn.gelu's constants as a bf16 array meets them (weak-typed floats)
SQRT_2_OVER_PI = _bf16(0.7978845608028654)
GELU_CUBIC = _bf16(0.044715)
SQRT_HALF = _bf16(0.7071067811865476)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def activation_bf16_plain(x: torch.Tensor, name: str,
                          dim: int | None = None) -> torch.Tensor:
    """Plain version: ``jax.nn``'s formula of ``name`` on the bf16 tensor
    ``x``, each torch op rounding its result to bf16 (a Python scalar is
    kept unrounded by torch, so the constants are rounded first)."""
    if name == "gelu_tanh":
        inner = SQRT_2_OVER_PI * (x + GELU_CUBIC * (x * x * x))
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    if name == "gelu_erf":
        return 0.5 * x * torch.special.erfc(-x * SQRT_HALF)
    if name == "silu":
        return x * _sigmoid(x)
    if name == "sigmoid":
        return _sigmoid(x)
    if name == "softmax":
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        return e / e.sum(dim=dim, keepdim=True)
    raise ValueError(f"activation_bf16: unknown activation {name!r}")


@functools.cache
def _fn():
    lib = _build.load("activations_bf16")
    fn = lib.activation_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def activation_bf16(x: torch.Tensor, name: str,
                    dim: int | None = None) -> torch.Tensor:
    """``name`` (``ACTIVATIONS``) of a bf16 tensor, rounding per op as
    ``jax.nn`` compiled without excess precision: the kernel on a CUDA
    tensor (one launch), the plain version on a CPU tensor. ``softmax``
    takes the ``dim`` it normalises over, the others none. Raises on
    another dtype, a non-contiguous CUDA tensor or an unknown name."""
    if name not in ACTIVATIONS:
        raise ValueError(f"activation_bf16: unknown activation {name!r}")
    if (name == "softmax") != (dim is not None):
        raise ValueError(f"activation_bf16: {name} with dim={dim}")
    if not on_cuda("activation_bf16", x, dtypes=(torch.bfloat16,)):
        return activation_bf16_plain(x, name, dim)
    if name == "softmax":
        dim = dim % x.ndim
        n = x.shape[dim]
        inner = math.prod(x.shape[dim + 1:])
        outer = math.prod(x.shape[:dim])
    else:
        n, inner, outer = 1, x.numel(), 1
    if x.numel() >= 2 ** 31:
        raise ValueError(f"activation_bf16: {x.numel()} values, the kernel "
                         f"takes fewer than 2**31")
    y = torch.empty_like(x)
    if x.numel():
        err = _fn()(x.data_ptr(), y.data_ptr(), ACTIVATIONS[name], outer, n,
                    inner, stream_handle(x))
        _build.check(err, f"activation_bf16 {name}")
    count_launch(activation_bf16, name)
    return y


activation_bf16.launches = 0
activation_bf16.form_launches = {}
