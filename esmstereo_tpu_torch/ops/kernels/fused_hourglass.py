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
two pointers. The fp32 forms run in fp32 and are held against the JAX
interpret-mode numbers, not the TPU's bf16 matrix-unit operands.

The deploy forms take bf16 tensors (``prepare_*_consts(...,
low_precision=True)``) and round where the TPU kernels round
(``:160,264,289-293`` for the down level, ``:472,585,616-622,656`` for the
up level): the raw weights in bf16, the products summed in fp32, each BN's
scale and shift applied in fp32 after its sum, and every intermediate (the
k3 s2 conv's output; the transposed conv's and the 1x1x1 conv's) rounded
to bf16, as it becomes the next matmul's operand there. They write bf16.
On the CPU nothing reproduces the TPU's operand rounding (interpret mode
runs fp32 operands), so the plain forms are held against interpret mode at
a stated number of bf16 ulps.

On CUDA a down level launches two kernels (k3 s2, then k3 s1) and an up
level three (the transposed conv, the 1x1x1 conv over ``[up | skip]``, the
k3 s1 conv), with the intermediates in device memory; each wrapper call
counts as one launch (``form_launches`` by ``"fp32"`` and ``"bf16"``).
The kernels tile output channels by 8 and mask the last tile, so any width
runs (L's 24, 40, 72; M's 16, 24, 40; S's 12, 16, 24); the 1x1x1 conv takes
at most 128 output channels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import bn_scale_shift, fold_bn
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)
from esmstereo_tpu_torch.ops.kernels.activations import gelu

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_CAT_CO = 128       # the 1x1x1 conv's 2 CO inputs fit kMaxCat = 256


def _consts(blocks_: dict, low_precision: bool, axes=None) -> dict:
    """``{"w<k>", "t<k>"}`` for each ``ConvBlock`` of ``blocks_`` (by key
    ``k``): the weight with the BN scale folded in and the shift; or, with
    ``low_precision``, ``{"w<k>", "s<k>", "t<k>"}``: the raw weight in bf16
    and the BN's fp32 scale and shift."""
    out = {}
    for k, blk in blocks_.items():
        if low_precision:
            s, t = bn_scale_shift(blk.bn)
            out.update({f"w{k}": blk.conv.weight.to(torch.bfloat16),
                        f"s{k}": s, f"t{k}": t})
        else:
            w, t = fold_bn(blk.conv.weight, blk.bn,
                           axis=(axes or {}).get(k, 0))
            out.update({f"w{k}": w, f"t{k}": t})
    return out


def prepare_down_consts(conv_s2, conv_s1, low_precision: bool = False
                        ) -> dict:
    """Weights of a down level's two ``ConvBlock(dims=3)`` modules, the k3
    s2 conv (``conv{k}_0``, key ``a``) and the k3 s1 conv (``conv{k}_1``,
    key ``b``): folded (``wa, ta, wb, tb``), or for the deploy form raw in
    bf16 with each BN's scale and shift (``wa, sa, ta, wb, sb, tb``)."""
    return _consts({"a": conv_s2, "b": conv_s1}, low_precision)


def prepare_up_consts(deconv, cat, conv, low_precision: bool = False
                      ) -> dict:
    """Weights of an up level: the k4 s2 transposed conv (``conv{k}_up``,
    weight ``(CI, CO, 4, 4, 4)``, key ``u``), the 1x1x1 conv over ``[up |
    skip]`` (``agg_*_0``, key ``c``) and the k3 conv (``agg_*_1``, key
    ``3``); folded, or raw in bf16 with scales and shifts, as
    ``prepare_down_consts``."""
    return _consts({"u": deconv, "c": cat, "3": conv}, low_precision,
                   axes={"u": 1})


def _low_precision(consts: dict, key: str) -> bool:
    return consts[key].dtype == torch.bfloat16


def _form(what: str, x: torch.Tensor, consts: dict, key: str) -> str:
    """``"bf16"`` for a bf16 input with deploy-form weights, ``"fp32"``
    for any other input with folded ones; raises on a mix."""
    form = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    if _low_precision(consts, key) != (form == "bf16"):
        raise TypeError(f"{what}: a {x.dtype} input with "
                        f"{consts[key].dtype} weights")
    return form


def bn_gelu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            approximate: bool) -> torch.Tensor:
    """A deploy form's epilogue on a (B, C, D, H, W) fp32 sum: ``GELU(y *
    scale + shift)``, the eval BN applied after the sum."""
    view = (1, -1, 1, 1, 1)
    return gelu(y * scale.view(view) + shift.view(view), approximate)


def _bn_gelu(y: torch.Tensor, consts: dict, k: str,
             approximate: bool) -> torch.Tensor:
    return bn_gelu(y, consts[f"s{k}"], consts[f"t{k}"], approximate)


def down_pair_plain(x: torch.Tensor, consts: dict,
                    approximate: bool) -> torch.Tensor:
    """Plain PyTorch version: conv3d k3 s2 p1, then k3 s1 p1 (BN folded),
    each + GELU; in the deploy form on bf16 operands, BN after each fp32
    sum, the intermediate and the output rounded to bf16."""
    if not _low_precision(consts, "wa"):
        y = gelu(F.conv3d(x, consts["wa"], consts["ta"], stride=2,
                          padding=1), approximate)
        return gelu(F.conv3d(y, consts["wb"], consts["tb"], padding=1),
                    approximate)
    bf16 = torch.bfloat16
    y = F.conv3d(x.float(), consts["wa"].float(), stride=2, padding=1)
    y = _bn_gelu(y, consts, "a", approximate).to(bf16)
    y = F.conv3d(y.float(), consts["wb"].float(), padding=1)
    return _bn_gelu(y, consts, "b", approximate).to(bf16)


def up_pair_plain(src: torch.Tensor, skip: torch.Tensor, consts: dict,
                  approximate: bool) -> torch.Tensor:
    """Plain PyTorch version: transposed conv k4 s2 p1 cropped to the skip's
    (D, H, W), concat with the skip, 1x1x1 conv, k3 s1 p1 conv (BN folded),
    each + GELU; in the deploy form on bf16 operands, BN after each fp32
    sum, each intermediate and the output rounded to bf16."""
    d2, h2, w2 = skip.shape[2:]
    if not _low_precision(consts, "wu"):
        up = F.conv_transpose3d(src, consts["wu"], consts["tu"], stride=2,
                                padding=1)
        up = gelu(up[:, :, :d2, :h2, :w2], approximate)
        z = gelu(F.conv3d(torch.cat([up, skip], dim=1), consts["wc"],
                          consts["tc"]), approximate)
        return gelu(F.conv3d(z, consts["w3"], consts["t3"], padding=1),
                    approximate)
    bf16 = torch.bfloat16
    up = F.conv_transpose3d(src.float(), consts["wu"].float(), stride=2,
                            padding=1)[:, :, :d2, :h2, :w2]
    up = _bn_gelu(up, consts, "u", approximate).to(bf16)
    z = F.conv3d(torch.cat([up, skip], dim=1).float(), consts["wc"].float())
    z = _bn_gelu(z, consts, "c", approximate).to(bf16)
    y = F.conv3d(z.float(), consts["w3"].float(), padding=1)
    return _bn_gelu(y, consts, "3", approximate).to(bf16)


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
    lowp.argtypes = [_P, _P, _P, _P, _P] + [_I] * 10 + [_P]
    deconv_bf16 = lib.hourglass_deconv_bf16
    deconv_bf16.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    cat_bf16 = lib.hourglass_conv1x1_cat_bf16
    cat_bf16.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    for fn in (conv, deconv, cat, lowp, deconv_bf16, cat_bf16):
        fn.restype = _I
    return conv, deconv, cat, lowp, deconv_bf16, cat_bf16


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
                        approximate: bool, stride: int = 1) -> torch.Tensor:
    """One launch of the direct conv3d k3 p1 in its deploy form on CUDA
    tensors (kernels C, E's agg, G and H): ``x`` bf16 or int8, ``w``
    ``(CO, CI, 3, 3, 3)`` bf16 (raw, BN not folded), fp32 sums, then
    ``GELU(sum * scale + shift)`` in fp32, written in ``out_dtype`` (bf16
    or fp32). bf16 -> bf16 takes stride 1 or 2 and any CO; the other forms
    stride 1 and CO a multiple of 8."""
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if (tuple(w.shape) != (co, ci, 3, 3, 3)
            or tuple(scale.shape) != (co,) or tuple(shift.shape) != (co,)):
        raise ValueError(f"conv3d bf16: weight {tuple(w.shape)} for {ci} "
                         f"inputs")
    if w.dtype != torch.bfloat16 or x.dtype not in _IN_CODES \
            or out_dtype not in _OUT_CODES:
        raise TypeError(f"conv3d bf16: {x.dtype} in, {w.dtype} weights, "
                        f"{out_dtype} out")
    if (x.dtype, out_dtype) != (torch.bfloat16, torch.bfloat16) \
            and (stride != 1 or co % 8):
        raise ValueError(f"conv3d bf16: {x.dtype} -> {out_dtype} takes "
                         f"stride 1 and CO a multiple of 8; got stride "
                         f"{stride}, CO {co}")
    out = [(n - 1) // stride + 1 for n in (d, h, wd)]
    y = torch.empty((b, co, *out), device=x.device, dtype=out_dtype)
    err = _fns()[3](x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), y.data_ptr(), b, ci, co, d, h, wd,
                    stride, _IN_CODES[x.dtype], _OUT_CODES[out_dtype],
                    int(approximate), stream_handle(x))
    _build.check(err, "conv3d bf16")
    return y


def down_pair(x: torch.Tensor, consts: dict,
              approximate: bool) -> torch.Tensor:
    """(B, CI, D, H, W) -> (B, CO, ceil(D/2), ceil(H/2), ceil(W/2)): the
    kernels on CUDA tensors, the plain version on CPU tensors."""
    if x.ndim != 5:
        raise ValueError(f"down_pair: input {tuple(x.shape)}")
    form = _form("down_pair", x, consts, "wa")
    if not on_cuda("down_pair", x, *consts.values(),
                   dtypes=(torch.float32, torch.bfloat16)):
        return down_pair_plain(x, consts, approximate)
    if form == "fp32":
        y = conv3d_bn_gelu(x, consts["wa"], consts["ta"], 2, approximate)
        y = conv3d_bn_gelu(y, consts["wb"], consts["tb"], 1, approximate)
    else:
        bf16 = torch.bfloat16
        y = conv3d_bn_gelu_bf16(x, consts["wa"], consts["sa"], consts["ta"],
                                bf16, approximate, stride=2)
        y = conv3d_bn_gelu_bf16(y, consts["wb"], consts["sb"], consts["tb"],
                                bf16, approximate)
    count_launch(down_pair, form)
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
    form = _form("up_pair", src, consts, "wu")
    if skip.dtype != src.dtype:
        raise TypeError(f"up_pair: src {src.dtype}, skip {skip.dtype}")
    if not on_cuda("up_pair", src, skip, *consts.values(),
                   dtypes=(torch.float32, torch.bfloat16)):
        return up_pair_plain(src, skip, consts, approximate)
    if co > _MAX_CAT_CO:
        raise NotImplementedError(f"up_pair kernel takes at most "
                                  f"{_MAX_CAT_CO} channels; got {co}")
    _, deconv, cat, _, deconv_bf16, cat_bf16 = _fns()
    approx = int(approximate)
    stream = stream_handle(src)
    up = torch.empty_like(skip)
    z = torch.empty_like(skip)
    if form == "fp32":
        err = deconv(src.data_ptr(), wu.data_ptr(), consts["tu"].data_ptr(),
                     up.data_ptr(), b, ci, co, ds, hs, ws, d2, h2, w2,
                     approx, stream)
        _build.check(err, "up_pair transposed conv")
        err = cat(up.data_ptr(), skip.data_ptr(), consts["wc"].data_ptr(),
                  consts["tc"].data_ptr(), z.data_ptr(), b, co,
                  d2 * h2 * w2, approx, stream)
        _build.check(err, "up_pair 1x1x1 conv")
        y = conv3d_bn_gelu(z, consts["w3"], consts["t3"], 1, approximate)
    else:
        err = deconv_bf16(src.data_ptr(), wu.data_ptr(),
                          consts["su"].data_ptr(), consts["tu"].data_ptr(),
                          up.data_ptr(), b, ci, co, ds, hs, ws, d2, h2, w2,
                          approx, stream)
        _build.check(err, "up_pair transposed conv bf16")
        err = cat_bf16(up.data_ptr(), skip.data_ptr(),
                       consts["wc"].data_ptr(), consts["sc"].data_ptr(),
                       consts["tc"].data_ptr(), z.data_ptr(), b, co,
                       d2 * h2 * w2, approx, stream)
        _build.check(err, "up_pair 1x1x1 conv bf16")
        y = conv3d_bn_gelu_bf16(z, consts["w3"], consts["s3"], consts["t3"],
                                torch.bfloat16, approximate)
    count_launch(up_pair, form)
    return y


down_pair.launches = 0
down_pair.form_launches = {}
up_pair.launches = 0
up_pair.form_launches = {}
