"""Kernels G and H: one down level and one up level of the 3-D hourglass,
every conv with its eval BatchNorm folded in and a GELU epilogue
(``csrc/fused_hourglass.cu``, whose direct k3 conv kernels C and E launch
too, through ``conv3d_bn_gelu``).

Replace ``esmstereo_tpu/attic/fused_hourglass.py::fused_down_pair_apply``
and ``::fused_up_pair_apply`` in the unfolded ``(B, C, D, H, W)`` layout.
As ``prepare_pair_consts`` and ``prepare_up_consts`` there (``:89,323``)
the eval BatchNorms fold into per-channel scales and offsets; here the
scales go into the conv weights. The JAX kernels' depth-interleaved concat
(``:386-392``) is, in this layout, the channel concat ``[up | skip]`` that
the port's ``Aggregation3D`` takes; the kernel reads its two halves through
two pointers. Everything runs in fp32 and is held against the JAX
interpret-mode numbers, not the TPU's bf16 matrix-unit operands.

On CUDA a down level launches two kernels (k3 s2, then k3 s1) and an up
level three (the transposed conv, the 1x1x1 conv over ``[up | skip]``, the
k3 s1 conv), with the intermediates in device memory; each wrapper call
counts as one launch. The kernels tile output channels by 8 and mask the
last tile, so any width runs (L's 24, 40, 72; M's 16, 24, 40; S's 12, 16,
24); the 1x1x1 conv takes at most 128 output channels.
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
_MAX_CAT_CO = 128       # the 1x1x1 conv's 2 CO inputs fit kMaxCat = 256


def prepare_down_consts(conv_s2, conv_s1) -> dict:
    """Folded weights of a down level's two ``ConvBlock(dims=3)`` modules:
    the k3 s2 conv (``conv{k}_0``) and the k3 s1 conv (``conv{k}_1``)."""
    wa, ta = fold_bn(conv_s2.conv.weight, conv_s2.bn)
    wb, tb = fold_bn(conv_s1.conv.weight, conv_s1.bn)
    return {"wa": wa, "ta": ta, "wb": wb, "tb": tb}


def prepare_up_consts(deconv, cat, conv) -> dict:
    """Folded weights of an up level: the k4 s2 transposed conv
    (``conv{k}_up``, weight ``(CI, CO, 4, 4, 4)``), the 1x1x1 conv over
    ``[up | skip]`` (``agg_*_0``) and the k3 conv (``agg_*_1``)."""
    wu, tu = fold_bn(deconv.conv.weight, deconv.bn, axis=1)
    wc, tc = fold_bn(cat.conv.weight, cat.bn)
    w3, t3 = fold_bn(conv.conv.weight, conv.bn)
    return {"wu": wu, "tu": tu, "wc": wc, "tc": tc, "w3": w3, "t3": t3}


def down_pair_plain(x: torch.Tensor, consts: dict,
                    approximate: bool) -> torch.Tensor:
    """Plain PyTorch version: conv3d k3 s2 p1, then k3 s1 p1 (BN folded),
    each + GELU."""
    y = gelu(F.conv3d(x, consts["wa"], consts["ta"], stride=2, padding=1),
             approximate)
    return gelu(F.conv3d(y, consts["wb"], consts["tb"], padding=1),
                approximate)


def up_pair_plain(src: torch.Tensor, skip: torch.Tensor, consts: dict,
                  approximate: bool) -> torch.Tensor:
    """Plain PyTorch version: transposed conv k4 s2 p1 cropped to the skip's
    (D, H, W), concat with the skip, 1x1x1 conv, k3 s1 p1 conv (BN folded),
    each + GELU."""
    d2, h2, w2 = skip.shape[2:]
    up = F.conv_transpose3d(src, consts["wu"], consts["tu"], stride=2,
                            padding=1)
    up = gelu(up[:, :, :d2, :h2, :w2], approximate)
    z = gelu(F.conv3d(torch.cat([up, skip], dim=1), consts["wc"],
                      consts["tc"]), approximate)
    return gelu(F.conv3d(z, consts["w3"], consts["t3"], padding=1),
                approximate)


@functools.cache
def _fns():
    lib = _build.load("fused_hourglass")
    conv = lib.conv3d_k3_bn_gelu
    conv.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
    deconv = lib.hourglass_deconv
    deconv.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [_P]
    cat = lib.hourglass_conv1x1_cat
    cat.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lowp = lib.conv3d_k3_bn_gelu_bf16
    lowp.argtypes = [_P, _P, _P, _P, _P] + [_I] * 9 + [_P]
    for fn in (conv, deconv, cat, lowp):
        fn.restype = _I
    return conv, deconv, cat, lowp


def conv3d_bn_gelu(x: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                   stride: int, approximate: bool) -> torch.Tensor:
    """One launch of the direct conv3d k3 p1 (stride 1 or 2) + folded BN +
    GELU on CUDA tensors: the conv of kernels C, E, G and H. ``w`` is
    ``(CO, CI, 3, 3, 3)`` with the BN scale folded in, ``t`` the shift."""
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3, 3) or tuple(t.shape) != (co,):
        raise ValueError(f"conv3d: weight {tuple(w.shape)} for {ci} inputs")
    out = [(n - 1) // stride + 1 for n in (d, h, wd)]
    y = torch.empty((b, co, *out), device=x.device, dtype=torch.float32)
    err = _fns()[0](x.data_ptr(), w.data_ptr(), t.data_ptr(), y.data_ptr(),
                    b, ci, co, d, h, wd, stride, int(approximate),
                    stream_handle(x))
    _build.check(err, "conv3d")
    return y


# the dtype codes of conv3d_k3_bn_gelu_bf16's input and output
_IN_CODES = {torch.bfloat16: 0, torch.int8: 1}
_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}


def conv3d_bn_gelu_bf16(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, out_dtype: torch.dtype,
                        approximate: bool) -> torch.Tensor:
    """One launch of the direct conv3d k3 s1 p1 in its deploy form on CUDA
    tensors (kernel C's bf16 and int8 forms): ``x`` bf16 or int8, ``w``
    ``(CO, CI, 3, 3, 3)`` bf16 (raw, BN not folded), fp32 sums, then
    ``GELU(sum * scale + shift)`` in fp32, written in ``out_dtype`` (bf16
    or fp32). CO must be a multiple of 8."""
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if (tuple(w.shape) != (co, ci, 3, 3, 3) or co % 8
            or tuple(scale.shape) != (co,) or tuple(shift.shape) != (co,)):
        raise ValueError(f"conv3d bf16: weight {tuple(w.shape)} for {ci} "
                         f"inputs")
    if w.dtype != torch.bfloat16 or x.dtype not in _IN_CODES \
            or out_dtype not in _OUT_CODES:
        raise TypeError(f"conv3d bf16: {x.dtype} in, {w.dtype} weights, "
                        f"{out_dtype} out")
    y = torch.empty((b, co, d, h, wd), device=x.device, dtype=out_dtype)
    err = _fns()[3](x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), y.data_ptr(), b, ci, co, d, h, wd,
                    _IN_CODES[x.dtype], _OUT_CODES[out_dtype],
                    int(approximate), stream_handle(x))
    _build.check(err, "conv3d bf16")
    return y


def down_pair(x: torch.Tensor, consts: dict,
              approximate: bool) -> torch.Tensor:
    """(B, CI, D, H, W) -> (B, CO, ceil(D/2), ceil(H/2), ceil(W/2)): the
    kernels on CUDA tensors, the plain version on CPU tensors."""
    if x.ndim != 5:
        raise ValueError(f"down_pair: input {tuple(x.shape)}")
    if not on_cuda("down_pair", x, *consts.values()):
        return down_pair_plain(x, consts, approximate)
    y = conv3d_bn_gelu(x, consts["wa"], consts["ta"], 2, approximate)
    y = conv3d_bn_gelu(y, consts["wb"], consts["tb"], 1, approximate)
    down_pair.launches += 1
    return y


def up_pair(src: torch.Tensor, skip: torch.Tensor, consts: dict,
            approximate: bool) -> torch.Tensor:
    """src (B, CI, Ds, Hs, Ws) and skip (B, CO, D2, H2, W2), with D2 <= 2 Ds,
    H2 <= 2 Hs, W2 <= 2 Ws -> (B, CO, D2, H2, W2): the kernels on CUDA
    tensors, the plain version on CPU tensors."""
    if src.ndim != 5 or skip.ndim != 5 or src.shape[0] != skip.shape[0]:
        raise ValueError(f"up_pair: src {tuple(src.shape)}, skip "
                         f"{tuple(skip.shape)}")
    b, ci, ds, hs, ws = src.shape
    co, d2, h2, w2 = skip.shape[1:]
    if any(n2 > 2 * n for n2, n in zip((d2, h2, w2), (ds, hs, ws))):
        raise ValueError(f"up_pair: skip {tuple(skip.shape)} larger than "
                         f"twice src {tuple(src.shape)}")
    wu = consts["wu"]
    if (tuple(wu.shape) != (ci, co, 4, 4, 4)
            or tuple(consts["wc"].shape) != (co, 2 * co, 1, 1, 1)
            or tuple(consts["w3"].shape) != (co, co, 3, 3, 3)):
        shapes = {k: tuple(v.shape) for k, v in consts.items()}
        raise ValueError(f"up_pair: weights {shapes} for src {ci} and skip "
                         f"{co} channels")
    if not on_cuda("up_pair", src, skip, *consts.values()):
        return up_pair_plain(src, skip, consts, approximate)
    if co > _MAX_CAT_CO:
        raise NotImplementedError(f"up_pair kernel takes at most "
                                  f"{_MAX_CAT_CO} channels; got {co}")
    _, deconv, cat, _ = _fns()
    approx = int(approximate)
    stream = stream_handle(src)
    up = torch.empty_like(skip)
    err = deconv(src.data_ptr(), wu.data_ptr(), consts["tu"].data_ptr(),
                 up.data_ptr(), b, ci, co, ds, hs, ws, d2, h2, w2, approx,
                 stream)
    _build.check(err, "up_pair transposed conv")
    z = torch.empty_like(skip)
    err = cat(up.data_ptr(), skip.data_ptr(), consts["wc"].data_ptr(),
              consts["tc"].data_ptr(), z.data_ptr(), b, co, d2 * h2 * w2,
              approx, stream)
    _build.check(err, "up_pair 1x1x1 conv")
    y = conv3d_bn_gelu(z, consts["w3"], consts["t3"], 1, approximate)
    up_pair.launches += 1
    return y


down_pair.launches = 0
up_pair.launches = 0
