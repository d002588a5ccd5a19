"""The eval model as a ``torch.export`` program and an AOTInductor package.

Counterpart of ``tools/export_stablehlo.py:54-83``: where the JAX package
traces ``infer(left, right)`` into StableHLO for a PJRT plugin, the port
traces it with ``torch.export`` and compiles the program with AOTInductor
into a ``.pt2`` package that ``serving/stereo_infer`` (C++) or
``torch._inductor.aoti_load_package`` (Python) runs.

``infer`` takes two NHWC normalised float32 images ``(1, H, W, 3)``, as
JAX's does, and returns the full-resolution disparity ``(1, H, W)``, or
``(disparity, confidence)`` for the confidence model. The hand kernels the
frame runs (A, B, and C's two convs) stay in the program as the opaque
operators ``esmstereo::`` (``ops/kernels/torch_ops.py``); AOTInductor
compiles only the glue around them, and ``aten.convolution`` stays an
extern cuDNN call. The trace runs under ``torch.no_grad()`` with TF32 off
(``eval.runner.fp32_precision``), and so does every run of it: the GELU
form and the compute dtype are the model's at trace time.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from esmstereo_tpu_torch.eval.runner import fp32_precision

# AOTInductor's settings: bf16 values are rounded where the eager ops round
# them (Inductor's fused kernels would otherwise keep them in fp32), which
# brings a package's deploy numerics nearest eager's (L-deploy at
# 384x1248 on the H100: mean distance 0.89 times eager's own from fp32,
# against 1.02 without)
INDUCTOR_CONFIGS = {"emulate_precision_casts": True}


@functools.cache
def wrapper_compiler() -> str:
    """The C++ compiler AOTInductor builds a package's wrapper with: the
    first of ``$CXX`` and the ``g++`` on ``PATH`` that compiles and links
    with OpenMP, which Inductor always asks for (``-fopenmp -lgomp``).
    Raises if none does."""
    candidates = [c for c in (os.environ.get("CXX"), shutil.which("g++"))
                  if c]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "omp.cc"
        src.write_text("#include <omp.h>\n"
                       "int main() { return omp_get_max_threads() < 1; }\n")
        for cxx in candidates:
            built = subprocess.run([cxx, "-fopenmp", str(src), "-o",
                                    str(Path(tmp) / "omp")],
                                   capture_output=True)
            if built.returncode == 0:
                return cxx
    raise RuntimeError(f"no C++ compiler among {candidates} links OpenMP, "
                       f"which AOTInductor's wrapper needs")


class Infer(torch.nn.Module):
    """``model`` as the exported function: ``(left, right) -> disparity``,
    or ``-> (disparity, confidence)`` with ``confidence``."""

    def __init__(self, model: torch.nn.Module, confidence: bool) -> None:
        super().__init__()
        self.model = model
        self.confidence = confidence

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        out = self.model(left, right)
        return (out[0], out[1]) if self.confidence else out[0]


def export_program(model: torch.nn.Module, height: int, width: int,
                   confidence: bool = False
                   ) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of ``model``'s eval ``infer`` at a fixed
    ``height`` x ``width`` (multiples of 32), on the model's device."""
    if height % 32 or width % 32:
        raise ValueError(f"export shapes must be multiples of 32, got "
                         f"{height}x{width}")
    device = next(model.parameters()).device
    # two tensors: one passed twice would be traced as one input
    left, right = (torch.zeros((1, height, width, 3), device=device)
                   for _ in range(2))
    with torch.no_grad(), fp32_precision():
        return torch.export.export(Infer(model.eval(), confidence),
                                   (left, right), strict=False)


def package(ep: torch.export.ExportedProgram, path: str) -> str:
    """Compile ``ep`` with AOTInductor (``INDUCTOR_CONFIGS``, the wrapper
    built by ``wrapper_compiler()``) into the package ``path``; returns its
    path."""
    configs = dict(INDUCTOR_CONFIGS, **{"cpp.cxx": (wrapper_compiler(),)})
    with fp32_precision():
        return torch._inductor.aoti_compile_and_package(
            ep, package_path=path, inductor_configs=configs)


def specs(ep: torch.export.ExportedProgram) -> tuple[list, list]:
    """(inputs, outputs) of ``ep``'s user signature as ``(shape, dtype)``
    pairs."""
    nodes = {n.name: n for n in ep.graph.nodes}

    def spec(node):
        val = node.meta["val"]
        return tuple(val.shape), val.dtype

    inputs = [spec(nodes[name]) for name in ep.graph_signature.user_inputs]
    out = next(n for n in ep.graph.nodes if n.op == "output")
    outputs = [spec(node) for node in out.args[0]]
    return inputs, outputs
