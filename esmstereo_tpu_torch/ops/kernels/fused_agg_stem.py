"""Kernels C and E: group_stem (corr_stem for norm-correlation) + agg, two
3x3x3 conv + eval BN + GELU layers on the cost volume (the direct conv of
``csrc/fused_hourglass.cu``, which the hourglass levels share), and the
same with the volume built inside group_stem (``csrc/fused_volume_agg.cu``).

C replaces ``esmstereo_tpu/ops/pallas/fused_agg_stem.py::folded_stem_agg_apply``
and E ``::folded_volume_stem_agg_apply``, in the unfolded
``(B, C, D, H, W)`` layout. As ``prepare_consts`` there (``:42-48,88``)
the eval BatchNorm folds into a per-channel scale and offset; here the
scale goes into the conv weights, and E takes C's consts. The kernels run
fp32 end to end and are held against the JAX interpret-mode numbers, not
the TPU's bf16 matrix-unit operands.

On CUDA, C's wrapper launches the direct-conv kernel twice (G -> 8, then
8 -> 8; G = 32 for gwc, 1 for norm-correlation), with the 8-channel
intermediate in device memory. E's launches the volume + group_stem
kernel, then C's 8 -> 8 conv; it reads the two descriptor maps and never
allocates the volume. Its normalised form first writes the two
L2-normalised maps into scratch with kernel B's ``l2_normalize_groups``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import fold_bn
from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle
from esmstereo_tpu_torch.ops.kernels.activations import gelu
from esmstereo_tpu_torch.ops.kernels import correlation
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import conv3d_bn_gelu

_P = ctypes.c_void_p
_I = ctypes.c_int


def prepare_consts(stem_block, agg_block) -> dict:
    """Folded weights of two ``ConvBlock(dims=3)`` modules (conv + bn)."""
    w1, t1 = fold_bn(stem_block.conv.weight, stem_block.bn)
    w2, t2 = fold_bn(agg_block.conv.weight, agg_block.bn)
    return {"w1": w1, "t1": t1, "w2": w2, "t2": t2}


def stem_agg_plain(vol: torch.Tensor, consts: dict,
                   approximate: bool) -> torch.Tensor:
    """Plain PyTorch version: conv3d (BN folded) + GELU, twice."""
    y = gelu(F.conv3d(vol, consts["w1"], consts["t1"], padding=1), approximate)
    return gelu(F.conv3d(y, consts["w2"], consts["t2"], padding=1), approximate)


def stem_agg(vol: torch.Tensor, consts: dict,
             approximate: bool) -> torch.Tensor:
    """(B, G, D, H, W) -> (B, 8, D, H, W), G = 32 (group_stem) or 1
    (corr_stem): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if vol.ndim != 5:
        raise ValueError(f"stem_agg: volume {tuple(vol.shape)}")
    if not on_cuda("stem_agg", vol, *consts.values()):
        return stem_agg_plain(vol, consts, approximate)
    y = conv3d_bn_gelu(vol, consts["w1"], consts["t1"], 1, approximate)
    y = conv3d_bn_gelu(y, consts["w2"], consts["t2"], 1, approximate)
    stem_agg.launches += 1
    return y


stem_agg.launches = 0


# --- kernel E: the volume built inside group_stem ----------------------------

def volume_stem_agg_plain(ref: torch.Tensor, tgt: torch.Tensor, consts: dict,
                          max_disp: int, num_groups: int, approximate: bool,
                          normalize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: kernel B's plain volume, then C's."""
    vol = correlation.correlation_volume_plain(ref, tgt, max_disp, num_groups,
                                               normalize)
    return stem_agg_plain(vol, consts, approximate)


@functools.cache
def _volume_fn():
    lib = _build.load("fused_volume_agg")
    fn = lib.volume_group_stem
    fn.argtypes = [_P, _P, _P, _P, _P] + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def volume_stem_agg(ref: torch.Tensor, tgt: torch.Tensor, consts: dict,
                    max_disp: int, num_groups: int, approximate: bool,
                    normalize: bool = False) -> torch.Tensor:
    """Descriptors (B, C, H, W) x 2 -> (B, 8, D, H, W), the same as
    ``stem_agg(correlation_volume(ref, tgt, D, G, normalize))``, with
    ``D = max_disp``: kernel E on CUDA tensors (the (B, G, D, H, W) volume
    is never allocated), the plain version on CPU tensors. Kernel E takes
    C=64 with G=32 (gwc) or G=1 (norm-correlation), with or without
    ``normalize``; it never falls back to B + C."""
    if ref.shape != tgt.shape or ref.ndim != 4:
        raise ValueError(f"volume_stem_agg: shapes {tuple(ref.shape)} "
                         f"{tuple(tgt.shape)}")
    b, c, h, w = ref.shape
    if c % num_groups or max_disp < 1:
        raise ValueError(f"volume_stem_agg: C={c}, G={num_groups}, "
                         f"D={max_disp}")
    if (tuple(consts["w1"].shape) != (8, num_groups, 3, 3, 3)
            or tuple(consts["t1"].shape) != (8,)):
        raise ValueError(f"volume_stem_agg: group_stem weight "
                         f"{tuple(consts['w1'].shape)} for {num_groups} "
                         f"groups")
    if not on_cuda("volume_stem_agg", ref, tgt, *consts.values()):
        return volume_stem_agg_plain(ref, tgt, consts, max_disp, num_groups,
                                     approximate, normalize)
    correlation.check_kernel_form("volume_stem_agg", c, num_groups)
    if normalize:
        ref, tgt = correlation.l2_normalize_pair(ref, tgt, num_groups)
    y = torch.empty((b, 8, max_disp, h, w), device=ref.device,
                    dtype=torch.float32)
    err = _volume_fn()(ref.data_ptr(), tgt.data_ptr(), consts["w1"].data_ptr(),
                       consts["t1"].data_ptr(), y.data_ptr(), b, c,
                       num_groups, 8, max_disp, h, w, int(approximate),
                       stream_handle(ref))
    _build.check(err, "volume_stem_agg")
    y = conv3d_bn_gelu(y, consts["w2"], consts["t2"], 1, approximate)
    volume_stem_agg.launches += 1
    return y


volume_stem_agg.launches = 0
