"""Kernel B: the group-wise correlation volume (``csrc/correlation.cu``).

Replaces ``esmstereo_tpu/ops/pallas/correlation.py::correlation_volume_folded``
in the unfolded ``(B, G, D, H, W)`` layout. fp32 products and group means;
the bf16 product rounding of the TPU deploy path is not part of this slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esmstereo_tpu_torch.ops.cost_volume import build_gwc_volume
from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle

_P = ctypes.c_void_p
_I = ctypes.c_int


def gwc_volume_plain(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Plain PyTorch version: ``ops.cost_volume.build_gwc_volume``."""
    return build_gwc_volume(ref, tgt, max_disp, num_groups)


@functools.cache
def _fn():
    lib = _build.load("correlation")
    fn = lib.gwc_volume
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def gwc_volume(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
               num_groups: int) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, G, D, H, W): the kernel on CUDA tensors, the
    plain version on CPU tensors. The kernel takes C=64, G=32 (the L path)."""
    if ref.shape != tgt.shape or ref.ndim != 4:
        raise ValueError(f"gwc_volume: shapes {tuple(ref.shape)} "
                         f"{tuple(tgt.shape)}")
    b, c, h, w = ref.shape
    if c % num_groups or max_disp < 1:
        raise ValueError(f"gwc_volume: C={c}, G={num_groups}, D={max_disp}")
    if not on_cuda("gwc_volume", ref, tgt):
        return gwc_volume_plain(ref, tgt, max_disp, num_groups)
    if (c, num_groups) != (64, 32):
        raise NotImplementedError(
            f"gwc_volume kernel takes C=64, G=32; got C={c}, G={num_groups}")
    out = torch.empty((b, num_groups, max_disp, h, w), device=ref.device,
                      dtype=torch.float32)
    err = _fn()(ref.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, c,
                num_groups, h, w, max_disp, stream_handle(ref))
    _build.check(err, "gwc_volume")
    gwc_volume.launches += 1
    return out


gwc_volume.launches = 0
