"""Plain versions of the kernels' device activations (``csrc/activations.cuh``).

``gelu_exact`` and ``gelu_tanh`` replace ``esmstereo_tpu/ops/pallas/
activations.py::gelu``; the A&S rational erf there exists only because
Mosaic has no ``erf``, and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return gelu_tanh(x) if approximate else gelu_exact(x)
