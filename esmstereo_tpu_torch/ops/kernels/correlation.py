"""Kernels B and D: the correlation cost volume (``csrc/correlation.cu``).

Replaces ``esmstereo_tpu/ops/pallas/correlation.py::correlation_volume``
(D) and ``::correlation_volume_folded`` (B) in the unfolded
``(B, G, D, H, W)`` layout: D's ``(B, D, H, W, G)`` volume with the G axis
moved, B's depth-folded one unfolded. As D, one function gives three forms:

  * ``num_groups=32, normalize=False``: group-wise correlation (gwc);
  * ``num_groups=32, normalize=True``:  gwc on L2-normalised groups;
  * ``num_groups=1,  normalize=True``:  norm-correlation.

In fp32 the products and group means are fp32. On bf16 descriptors (the
gwc deploy form, ``G = 32``) each product is formed exactly in fp32 and
rounded to bf16, the group's rounded products are summed in fp32 and
scaled by 1/(C/G), and the volume is written in bf16: the arithmetic of
B's bf16 branch (``esmstereo_tpu/ops/pallas/correlation.py:114-122``),
whose bf16 dot against the 1/(C/G) group matrix accumulates in fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esmstereo_tpu_torch.ops.cost_volume import (build_gwc_volume,
                                                 build_gwc_volume_norm,
                                                 build_norm_correlation_volume)
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)

_P = ctypes.c_void_p
_I = ctypes.c_int
# (C, G) instances of the CUDA kernel
KERNEL_FORMS = ((64, 32), (64, 1))


def gwc_volume_bf16_plain(ref: torch.Tensor, tgt: torch.Tensor,
                          max_disp: int, num_groups: int) -> torch.Tensor:
    """Plain version of the bf16 form: (B, C, H, W) bf16 x 2 -> (B, G, D,
    H, W) bf16, each product rounded to bf16 before the group mean."""
    b, c, h, w = ref.shape
    cpg = c // num_groups
    r = ref.float()
    padded = torch.nn.functional.pad(tgt.float(), (max_disp - 1, 0))
    off = max_disp - 1
    planes = []
    for d in range(max_disp):
        prod = (r * padded[..., off - d:off - d + w]).to(torch.bfloat16)
        s = prod.float().view(b, num_groups, cpg, h, w).sum(dim=2)
        planes.append((s * (1.0 / cpg)).to(torch.bfloat16))
    return torch.stack(planes, dim=2)


def correlation_volume_plain(ref: torch.Tensor, tgt: torch.Tensor,
                             max_disp: int, num_groups: int,
                             normalize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the ``ops.cost_volume`` builder of the form,
    or ``gwc_volume_bf16_plain`` on bf16 descriptors."""
    if ref.dtype == torch.bfloat16:
        check_bf16_form("correlation_volume", num_groups, normalize)
        return gwc_volume_bf16_plain(ref, tgt, max_disp, num_groups)
    if not normalize:
        return build_gwc_volume(ref, tgt, max_disp, num_groups)
    if num_groups == 1:
        return build_norm_correlation_volume(ref, tgt, max_disp)
    return build_gwc_volume_norm(ref, tgt, max_disp, num_groups)


@functools.cache
def _fns():
    lib = _build.load("correlation")
    vol = lib.correlation_volume
    vol.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    norm = lib.l2_normalize_groups
    norm.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    for fn in (vol, norm):
        fn.restype = _I
    return vol, norm


def check_bf16_form(what: str, num_groups: int, normalize: bool) -> None:
    """The bf16 form is the gwc volume (32 groups, not normalised); the
    normalised bf16 forms are not ported (``ROADMAP.md``)."""
    if normalize or num_groups != 32:
        raise NotImplementedError(
            f"{what}: bf16 takes the gwc volume (32 groups); got "
            f"{num_groups} groups, normalize={normalize}")


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
    """(B, C, H, W) x 2 -> (B, G, D, H, W) in the descriptors' dtype: the
    kernel on CUDA tensors, the plain version on CPU tensors. The kernel
    takes C=64 with G=32 (gwc, gwc_norm) or G=1 (norm-correlation) in fp32,
    and the gwc form (G=32) in bf16."""
    if ref.shape != tgt.shape or ref.ndim != 4:
        raise ValueError(f"correlation_volume: shapes {tuple(ref.shape)} "
                         f"{tuple(tgt.shape)}")
    b, c, h, w = ref.shape
    if c % num_groups or max_disp < 1:
        raise ValueError(f"correlation_volume: C={c}, G={num_groups}, "
                         f"D={max_disp}")
    if ref.dtype != tgt.dtype:
        raise TypeError(f"correlation_volume: {ref.dtype} and {tgt.dtype}")
    if not on_cuda("correlation_volume", ref, tgt,
                   dtypes=(torch.float32, torch.bfloat16)):
        return correlation_volume_plain(ref, tgt, max_disp, num_groups,
                                        normalize)
    check_kernel_form("correlation_volume", c, num_groups)
    bf16 = ref.dtype == torch.bfloat16
    if bf16:
        check_bf16_form("correlation_volume", num_groups, normalize)
    if normalize:
        ref, tgt = l2_normalize_pair(ref, tgt, num_groups)
    out = torch.empty((b, num_groups, max_disp, h, w), device=ref.device,
                      dtype=ref.dtype)
    err = _fns()[0](ref.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, c,
                    num_groups, h, w, max_disp, int(bf16), stream_handle(ref))
    _build.check(err, "correlation_volume")
    count_launch(correlation_volume, "bf16" if bf16 else "fp32")
    return out


correlation_volume.launches = 0
correlation_volume.form_launches = {}
