"""Kernels B and D: the correlation cost volume (``csrc/correlation.cu``).

Replaces ``esmstereo_tpu/ops/pallas/correlation.py::correlation_volume``
(D) and ``::correlation_volume_folded`` (B) in the unfolded
``(B, G, D, H, W)`` layout: D's ``(B, D, H, W, G)`` volume with the G axis
moved, B's depth-folded one unfolded. As D, one function gives three forms:

  * ``num_groups=32, normalize=False``: group-wise correlation (gwc);
  * ``num_groups=32, normalize=True``:  gwc on L2-normalised groups;
  * ``num_groups=1,  normalize=True``:  norm-correlation.

fp32 products and group means; the bf16 product rounding of the TPU deploy
path is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esmstereo_tpu_torch.ops.cost_volume import (build_gwc_volume,
                                                 build_gwc_volume_norm,
                                                 build_norm_correlation_volume)
from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle

_P = ctypes.c_void_p
_I = ctypes.c_int
# (C, G) instances of the CUDA kernel
KERNEL_FORMS = ((64, 32), (64, 1))


def correlation_volume_plain(ref: torch.Tensor, tgt: torch.Tensor,
                             max_disp: int, num_groups: int,
                             normalize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the ``ops.cost_volume`` builder of the form."""
    if not normalize:
        return build_gwc_volume(ref, tgt, max_disp, num_groups)
    if num_groups == 1:
        return build_norm_correlation_volume(ref, tgt, max_disp)
    return build_gwc_volume_norm(ref, tgt, max_disp, num_groups)


@functools.cache
def _fns():
    lib = _build.load("correlation")
    vol = lib.correlation_volume
    vol.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    norm = lib.l2_normalize_groups
    norm.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    for fn in (vol, norm):
        fn.restype = _I
    return vol, norm


def check_kernel_form(what: str, c: int, num_groups: int) -> None:
    if (c, num_groups) not in KERNEL_FORMS:
        raise NotImplementedError(
            f"{what} kernel takes (C, G) in {KERNEL_FORMS}; got "
            f"({c}, {num_groups})")


def l2_normalize_pair(ref: torch.Tensor, tgt: torch.Tensor, num_groups: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both CUDA maps scaled to ``x / (||x_g|| + 1e-5)`` per pixel and
    group, into new tensors, in one launch of ``l2_normalize_groups``: the
    first step of kernels B, D and E on their normalised forms."""
    b, c, h, w = ref.shape
    out_r, out_t = torch.empty_like(ref), torch.empty_like(tgt)
    err = _fns()[1](ref.data_ptr(), tgt.data_ptr(), out_r.data_ptr(),
                    out_t.data_ptr(), b, c, num_groups, h, w,
                    stream_handle(ref))
    _build.check(err, "l2_normalize_groups")
    return out_r, out_t


def correlation_volume(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                       num_groups: int, normalize: bool = False
                       ) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, G, D, H, W): the kernel on CUDA tensors, the
    plain version on CPU tensors. The kernel takes C=64 with G=32 (gwc,
    gwc_norm) or G=1 (norm-correlation)."""
    if ref.shape != tgt.shape or ref.ndim != 4:
        raise ValueError(f"correlation_volume: shapes {tuple(ref.shape)} "
                         f"{tuple(tgt.shape)}")
    b, c, h, w = ref.shape
    if c % num_groups or max_disp < 1:
        raise ValueError(f"correlation_volume: C={c}, G={num_groups}, "
                         f"D={max_disp}")
    if not on_cuda("correlation_volume", ref, tgt):
        return correlation_volume_plain(ref, tgt, max_disp, num_groups,
                                        normalize)
    check_kernel_form("correlation_volume", c, num_groups)
    if normalize:
        ref, tgt = l2_normalize_pair(ref, tgt, num_groups)
    out = torch.empty((b, num_groups, max_disp, h, w), device=ref.device,
                      dtype=torch.float32)
    err = _fns()[0](ref.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, c,
                    num_groups, h, w, max_disp, stream_handle(ref))
    _build.check(err, "correlation_volume")
    correlation_volume.launches += 1
    return out


correlation_volume.launches = 0
