"""Kernel C: group_stem + agg, two 3x3x3 conv + eval BN + GELU layers on the
cost volume (``csrc/fused_agg_stem.cu``).

Replaces ``esmstereo_tpu/ops/pallas/fused_agg_stem.py::folded_stem_agg_apply``
in the unfolded ``(B, C, D, H, W)`` layout. As ``prepare_consts`` there
(``:42-48,88``) the eval BatchNorm folds into a per-channel scale and
offset; here the scale goes into the conv weights. The kernel runs fp32
end to end and is held against the JAX interpret-mode numbers, not the
TPU's bf16 matrix-unit operands.

On CUDA the wrapper launches the direct-conv kernel twice (32 -> 8, then
8 -> 8), with the 8-channel intermediate in device memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import fold_bn
from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle
from esmstereo_tpu_torch.ops.kernels.activations import gelu

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


@functools.cache
def _fn():
    lib = _build.load("fused_agg_stem")
    fn = lib.conv3d_bn_gelu
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _launch(fn, x: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
            approximate: bool) -> torch.Tensor:
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3, 3) or tuple(t.shape) != (co,):
        raise ValueError(f"stem_agg: weight {tuple(w.shape)} for {ci} inputs")
    if (ci, co) not in ((32, 8), (8, 8)):
        raise NotImplementedError(
            f"stem_agg kernel takes 32->8 and 8->8 convs; got {ci}->{co}")
    y = torch.empty((b, co, d, h, wd), device=x.device, dtype=torch.float32)
    err = fn(x.data_ptr(), w.data_ptr(), t.data_ptr(), y.data_ptr(), b, ci,
             co, d, h, wd, int(approximate), stream_handle(x))
    _build.check(err, "stem_agg")
    return y


def stem_agg(vol: torch.Tensor, consts: dict,
             approximate: bool) -> torch.Tensor:
    """(B, 32, D, H, W) -> (B, 8, D, H, W): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if vol.ndim != 5:
        raise ValueError(f"stem_agg: volume {tuple(vol.shape)}")
    if not on_cuda("stem_agg", vol, *consts.values()):
        return stem_agg_plain(vol, consts, approximate)
    fn = _fn()
    y = _launch(fn, vol, consts["w1"], consts["t1"], approximate)
    y = _launch(fn, y, consts["w2"], consts["t2"], approximate)
    stem_agg.launches += 1
    return y


stem_agg.launches = 0
