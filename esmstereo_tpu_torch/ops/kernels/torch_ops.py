"""The hand kernels an exported model reaches, as PyTorch operators.

Kernel A (``fused_head.fused_stage0``), kernel B (``correlation.
correlation_volume``) and the conv3d k3 p1 that kernel C launches twice
(``fused_hourglass.conv3d_bn_gelu`` and ``conv3d_bn_gelu_bf16``) call
``torch.ops.esmstereo.<name>`` on both devices, so an eager frame and a
``torch.export`` graph (``export/program.py``) take one launch route:

  * the schemas are the one table ``SCHEMAS``; this module defines them
    once per process, at import;
  * each op's CPU kernel is its wrapper's plain version, and its fake
    kernel (shape and dtype) follows the wrapper's rules; the kernel
    modules register both (``register``);
  * its CUDA kernel is ``csrc/torch_ops.cpp``, built into the ops library
    by ``_build.build_ops`` and loaded here at the first CUDA call
    (``load_cuda``), which raises if it does not build or load;
  * the launch plan that Python computes (``stage0_plan``, ``corr_plan``,
    ``conv_plan``) is an ``int[]`` argument, empty on the CPU, where no
    kernel reads it; an output dtype is a ``bool`` (bf16 or not), not a
    ``ScalarType``, which torch 2.11's AOTInductor proxy executor hands
    the kernel as the export format's enum value (bf16 arrived as
    QUInt8).

A process without Python (the runner of ``serving/``) loads the
definitions library, built from ``defs_source()``, the C++ text of the same
table, and then the ops library. A Python process never loads the
definitions library: a second ``TORCH_LIBRARY(esmstereo, ...)`` in one
process aborts it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esmstereo_tpu_torch.ops.kernels import _build

NAMESPACE = "esmstereo"
# name -> schema; csrc/torch_ops.cpp registers a CUDA kernel for each, in
# this order (its launch counters' order)
SCHEMAS = {
    "fused_stage0": "fused_stage0(Tensor img, Tensor params, int form, "
                    "bool out_bf16, int[] plan) -> Tensor",
    "correlation_volume": "correlation_volume(Tensor ref, Tensor tgt, "
                          "int max_disp, int num_groups, bool normalize, "
                          "bool round_products, int[] plan) -> Tensor",
    "conv3d_bn_gelu": "conv3d_bn_gelu(Tensor x, Tensor w, Tensor t, "
                      "int stride, bool approximate, int[] plan) -> Tensor",
    "conv3d_bn_gelu_bf16": "conv3d_bn_gelu_bf16(Tensor x, Tensor w, "
                           "Tensor scale, Tensor shift, bool out_fp32, "
                           "int stride, bool approximate, int[] plan) "
                           "-> Tensor",
}

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _schema in SCHEMAS.values():
    _LIB.define(_schema)


def qualname(name: str) -> str:
    return f"{NAMESPACE}::{name}"


def register(name: str, cpu, fake) -> None:
    """``cpu`` as the op's CPU kernel and ``fake`` as its fake kernel;
    each takes the op's arguments in schema order."""
    torch.library.impl(qualname(name), "CPU", lib=_LIB)(cpu)
    torch.library.register_fake(qualname(name), lib=_LIB)(fake)


def op(name: str):
    """``torch.ops.esmstereo.<name>``."""
    return getattr(getattr(torch.ops, NAMESPACE), name)


def defs_source() -> str:
    """The definitions library's C++ source: ``SCHEMAS`` under one
    ``TORCH_LIBRARY``."""
    lines = [f"// Generated from {__name__}.SCHEMAS; do not edit.",
             "#include <torch/library.h>", "",
             f"TORCH_LIBRARY({NAMESPACE}, m) {{"]
    lines += [f'    m.def("{s}");' for s in SCHEMAS.values()]
    return "\n".join(lines + ["}", ""])


@functools.cache
def load_cuda() -> ctypes.CDLL:
    """Build the ops library (``_build.build_ops``) and load it into this
    process, once: the ops' CUDA kernels. Raises if it fails to build or
    load. Returns it for its launch counters (``op_launches``)."""
    path = _build.build_ops()["esmstereo_ops"]
    torch.ops.load_library(str(path))
    lib = ctypes.CDLL(str(path))
    lib.esmstereo_op_launches.restype = ctypes.c_longlong
    lib.esmstereo_op_launches.argtypes = [ctypes.c_int]
    lib.esmstereo_op_name.restype = ctypes.c_char_p
    lib.esmstereo_op_name.argtypes = [ctypes.c_int]
    lib.esmstereo_ops_count.restype = ctypes.c_int
    names = [lib.esmstereo_op_name(i).decode()
             for i in range(lib.esmstereo_ops_count())]
    if names != list(SCHEMAS):
        raise RuntimeError(f"the ops library registers {names}, the schema "
                           f"table {list(SCHEMAS)}")
    return lib


def op_launches() -> dict:
    """``{op name: CUDA launches}`` that the ops library has counted in
    this process (nothing before ``load_cuda``)."""
    if load_cuda.cache_info().currsize == 0:
        return dict.fromkeys(SCHEMAS, 0)
    lib = load_cuda()
    return {n: lib.esmstereo_op_launches(i) for i, n in enumerate(SCHEMAS)}


def reset_op_launches() -> None:
    if load_cuda.cache_info().currsize:
        load_cuda().esmstereo_reset_op_launches()
