"""Hand-written CUDA kernels of the L eval path, each beside its plain
PyTorch version.

  * ``fused_head.fused_stage0``      kernel A, backbone stem + stage 0
  * ``correlation.gwc_volume``       kernel B, group-wise correlation volume
  * ``fused_agg_stem.stem_agg``      kernel C, group_stem + agg 3-D convs

A wrapper runs the plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device, raising on anything the
kernel does not take; it never falls back. ``wrapper.launches`` counts the
calls that launched the kernel.

Kernels launch on the current stream and allocate nothing; the wrappers
allocate outputs and scratch with ``torch.empty``. Scratch that goes out of
scope right after a launch is safe to free, because PyTorch's caching
allocator hands the memory out again only in that stream's order.
"""

from __future__ import annotations

import torch


def wrappers() -> dict:
    """``{kernel name: wrapper}`` for the kernels of the L eval path."""
    from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
    from esmstereo_tpu_torch.ops.kernels import fused_head

    return {"fused_stage0": fused_head.fused_stage0,
            "gwc_volume": correlation.gwc_volume,
            "stem_agg": fused_agg_stem.stem_agg}


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on fp32
    violations, mixed devices or another device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: fp32 only in this slice, got {t.dtype}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{what}: CUDA kernel needs contiguous inputs")
    return dev.type == "cuda"


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
