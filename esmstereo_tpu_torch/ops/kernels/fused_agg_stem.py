"""Kernels C and E: group_stem (corr_stem for norm-correlation) + agg, two
3x3x3 conv + eval BN + GELU layers on the cost volume (the direct conv of
``csrc/fused_hourglass.cu``, which the hourglass levels share), and the
same with the volume built inside group_stem (``csrc/fused_volume_agg.cu``).

C replaces ``esmstereo_tpu/ops/pallas/fused_agg_stem.py::folded_stem_agg_apply``
and E ``::folded_volume_stem_agg_apply``, in the unfolded
``(B, C, D, H, W)`` layout. As ``prepare_consts`` there (``:42-48,88``)
the eval BatchNorm folds into a per-channel scale and offset; here the
scale goes into the conv weights, and E takes C's consts. The fp32 forms
run fp32 end to end and are held against the JAX interpret-mode numbers,
not the TPU's bf16 matrix-unit operands.

C's deploy forms take a bf16 or an int8 volume (``prepare_consts(...,
low_precision=True)``) and round where the TPU kernel rounds
(``fused_agg_stem.py:84-86,141-155,189-192`` there): conv1's raw weights
(times the int8 volume's dequantisation scale, ``with_input_scale``) and
conv2's in bf16, conv1's GELU output to bf16 before conv2, the products
summed in fp32, and the BN scale and shift applied in fp32 after the sum,
not folded into the rounded weights. They write bf16 (or fp32 from an int8
volume, ``out_dtype``). On the CPU nothing reproduces the TPU's operand
rounding (interpret mode runs fp32 operands), so the plain forms are held
against interpret mode at a stated number of bf16 ulps.

E's bf16 form takes bf16 descriptors and C's deploy-form consts and
rounds where the TPU kernel rounds (``fused_agg_stem.py:448-453`` there):
the volume in kernel B's bf16 rounding, then C's bf16 form, so its plain
version is B's plain bf16 form followed by C's, and the kernel equals that
pair without ever holding the volume.

On CUDA, C's wrapper launches the shared conv3d kernel twice (G -> 8, then
8 -> 8; G = 32 for gwc, 1 for norm-correlation), with the 8-channel
intermediate in device memory (bf16 in the deploy forms). E's launches
the volume + group_stem kernel (``csrc/fused_volume_agg.cu``: the same
conv, on the tensor cores in the bf16 forms, with its slab built from the
descriptors), laid out by ``volume_plan`` as ``conv_plan`` lays out C's
group_stem, then C's 8 -> 8 conv; it reads the two descriptor maps and
never allocates the volume. Its normalised form first writes the two
L2-normalised maps into scratch (fp32, from fp32 or bf16 descriptors) with
kernel B's ``l2_normalize_groups``. Both wrappers count launches by form
(``form_launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import bn_scale_shift, fold_bn
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)
from esmstereo_tpu_torch.ops.kernels.activations import gelu
from esmstereo_tpu_torch.ops.kernels import correlation
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import (
    SMEM_MAX, SMS, ConvPlan, bn_gelu, conv3d_bn_gelu, conv3d_bn_gelu_bf16,
    conv_layout, conv_plan)

_P = ctypes.c_void_p
_I = ctypes.c_int


def prepare_consts(stem_block, agg_block, low_precision: bool = False
                   ) -> dict:
    """Weights of two ``ConvBlock(dims=3)`` modules (conv + bn): fp32 with
    the BN scale folded in and the shift (``w1, t1, w2, t2``); or, for the
    deploy forms, the raw weights in bf16 and each BN's fp32 scale and
    shift (``w1, s1, t1, w2, s2, t2``)."""
    if not low_precision:
        w1, t1 = fold_bn(stem_block.conv.weight, stem_block.bn)
        w2, t2 = fold_bn(agg_block.conv.weight, agg_block.bn)
        return {"w1": w1, "t1": t1, "w2": w2, "t2": t2}
    s1, t1 = bn_scale_shift(stem_block.bn)
    s2, t2 = bn_scale_shift(agg_block.bn)
    return {"w1": stem_block.conv.weight.to(torch.bfloat16), "s1": s1,
            "t1": t1, "w2": agg_block.conv.weight.to(torch.bfloat16),
            "s2": s2, "t2": t2}


def with_input_scale(consts: dict, w1: torch.Tensor,
                     scale: torch.Tensor) -> dict:
    """Deploy-form ``consts`` for an int8 volume of dequantisation
    ``scale`` (a 0-d fp32 tensor): conv1's raw fp32 weight ``w1`` times the
    scale, then rounded to bf16, as ``prepare_consts(input_scale=...)`` and
    the TPU kernel's operand cast do in JAX."""
    return dict(consts, w1=(w1.float() * scale).to(torch.bfloat16))


def quantize_volume(vol: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-batch int8 quantisation (``esmstereo_tpu/models/
    esmstereo.py:691-705``): ``vmax = max(max|v|, 1e-12)``, ``q =
    clip(round(v * 127 / vmax), -127, 127)`` (round half to even, as jnp
    rounds); returns ``(q, vmax / 127)``. Plain torch ops, as in JAX."""
    vf = vol.float()
    vmax = torch.clamp(vf.abs().max(), min=1e-12)
    q = torch.clamp(torch.round(vf * (127.0 / vmax)), -127.0, 127.0)
    return q.to(torch.int8), vmax / 127.0


def _low_precision(consts: dict) -> bool:
    return consts["w1"].dtype == torch.bfloat16


def stem_agg_plain(vol: torch.Tensor, consts: dict, approximate: bool,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: conv3d (BN folded) + GELU, twice; in the
    deploy forms the same with the operands rounded to bf16 and BN applied
    after each fp32 sum."""
    return _stem_agg_steps(vol, consts, approximate, out_dtype)[1]


def _stem_agg_steps(vol: torch.Tensor, consts: dict, approximate: bool,
                    out_dtype: torch.dtype | None = None) -> tuple:
    """``stem_agg_plain``'s two layers: (group_stem's output, the output);
    the first in bf16 in the deploy forms."""
    if not _low_precision(consts):
        y = gelu(F.conv3d(vol, consts["w1"], consts["t1"], padding=1),
                 approximate)
        return y, gelu(F.conv3d(y, consts["w2"], consts["t2"], padding=1),
                       approximate)

    def layer(x, i):
        return bn_gelu(F.conv3d(x, consts[f"w{i}"].float(), padding=1),
                       consts[f"s{i}"], consts[f"t{i}"], approximate)

    y = layer(vol.float(), 1).to(torch.bfloat16)
    return y, layer(y.float(), 2).to(_out_dtype(vol, out_dtype))


# the deploy forms, by the volume's dtype (any other is the fp32 form's)
_DEPLOY_FORMS = {torch.bfloat16: "bf16", torch.int8: "int8"}


def _out_dtype(vol: torch.Tensor, out_dtype) -> torch.dtype:
    """The output dtype of C on ``vol``: the volume's, and for an int8
    volume ``out_dtype`` (bf16 or fp32), which must then be given (as in
    JAX)."""
    if _DEPLOY_FORMS.get(vol.dtype) == "int8":
        if out_dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"stem_agg: the int8 form writes bf16 or fp32, "
                            f"not {out_dtype}")
        return out_dtype
    if out_dtype not in (None, vol.dtype):
        raise TypeError(f"stem_agg: a {vol.dtype} volume gives "
                        f"{vol.dtype}, not {out_dtype}")
    return vol.dtype


def stem_agg(vol: torch.Tensor, consts: dict, approximate: bool,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, G, D, H, W) -> (B, 8, D, H, W), G = 32 (group_stem) or 1
    (corr_stem): the kernel on CUDA tensors, the plain version on CPU
    tensors. An fp32 volume takes fp32 ``consts``; a bf16 or an int8 one
    (the deploy forms) takes ``prepare_consts(..., low_precision=True)``,
    through ``with_input_scale`` for int8, and writes bf16 or, from int8,
    ``out_dtype``."""
    if vol.ndim != 5:
        raise ValueError(f"stem_agg: volume {tuple(vol.shape)}")
    form = _DEPLOY_FORMS.get(vol.dtype, "fp32")
    if _low_precision(consts) != (form != "fp32"):
        raise TypeError(f"stem_agg: a {vol.dtype} volume with "
                        f"{consts['w1'].dtype} weights")
    out = _out_dtype(vol, out_dtype)
    if not on_cuda("stem_agg", vol, *consts.values(),
                   dtypes=(torch.float32, torch.bfloat16, torch.int8)):
        return stem_agg_plain(vol, consts, approximate, out_dtype)
    if form == "fp32":
        y = conv3d_bn_gelu(vol, consts["w1"], consts["t1"], 1, approximate)
        y = conv3d_bn_gelu(y, consts["w2"], consts["t2"], 1, approximate)
    else:
        y = conv3d_bn_gelu_bf16(vol, consts["w1"], consts["s1"],
                                consts["t1"], torch.bfloat16, approximate)
        y = conv3d_bn_gelu_bf16(y, consts["w2"], consts["s2"], consts["t2"],
                                out, approximate)
    count_launch(stem_agg, form)
    return y


stem_agg.launches = 0
stem_agg.form_launches = {}


# --- kernel E: the volume built inside group_stem ----------------------------

def volume_stem_agg_plain(ref: torch.Tensor, tgt: torch.Tensor, consts: dict,
                          max_disp: int, num_groups: int, approximate: bool,
                          normalize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: kernel B's plain volume (its bf16 form on
    bf16 descriptors), then C's."""
    vol = correlation.correlation_volume_plain(ref, tgt, max_disp, num_groups,
                                               normalize)
    return stem_agg_plain(vol, consts, approximate)


# --- E's launch plan: kernel C's group_stem plan plus the slab producer ----

VOLUME_CHANNELS = 64        # the descriptors' channels E takes
# the MMA form's producer warps: 4 at G = 32 (as kernel C's group_stem),
# 8 at G = 1, whose one chunk of 64-channel dots is the work
LOAD_WARPS = {32: 4, 1: 8}
# the fp32 form's descriptor channels a unit (double-buffered by cp.async),
# and its warps in multiples of its conv's at G = 1, where building the
# 64-channel dots is the work (``kFp32Build`` in the source)
FP32_SUB = 16
FP32_BUILD = {32: 1, 1: 2}
# the MMA form's tiles (rows, depths), largest first: E builds each slab
# entry of a tile's halo too, so a deeper tile than C's (4, 2) at G = 32
# builds fewer entries an output (``eval/volume_check.py --tile 4 2``
# times the other; PERF.md section 6); the tile does not enter the sums,
# whose order is the chunks' and the taps'
MMA_TILES = ((4, 4), (4, 2), (2, 2))


@dataclasses.dataclass(frozen=True)
class VolumePlan:
    """How kernel E's volume + group_stem launches
    (``csrc/fused_volume_agg.cu``): ``conv`` is the conv's plan (kernel
    C's group_stem's chunks and cluster split, and a tile), ``smem`` the block's
    dynamic shared memory with the producer's buffers, ``load_warps`` the
    MMA form's producer warps (the fp32 form's warps), ``sub`` the fp32
    form's descriptor channels a unit, ``desc_bytes`` the producer's
    descriptor buffers."""

    conv: ConvPlan
    groups: int
    smem: int
    load_warps: int
    sub: int
    desc_bytes: int

    @property
    def threads(self) -> int:
        if self.conv.form == "fp32":
            return 32 * self.load_warps
        return 32 * (4 + self.load_warps)

    def ints(self, batch: int, code: int, approximate: bool
             ) -> ctypes.Array:
        """The C entry point's plan argument: 15 ints (B, C, G, D, H, W,
        form code, tile_h, tile_d, cluster, smem, approximate, k_chunk,
        load_warps, sub)."""
        d, h, w = self.conv.conv[2:5]
        return (ctypes.c_int * 15)(
            batch, VOLUME_CHANNELS, self.groups, d, h, w, code,
            *self.conv.tile[1:], self.conv.cluster, self.smem,
            int(approximate), self.conv.k_chunk, self.load_warps, self.sub)


@functools.lru_cache(maxsize=None)
def volume_plan(form: str, groups: int, d: int, h: int, w: int,
                desc_bytes: int = 2) -> VolumePlan:
    """The plan of kernel E at ``groups`` (32 or 1) over a ``(d, h, w)``
    volume, in ``form`` ``"fp32"`` or ``"bf16"`` (``desc_bytes`` the
    descriptors' bytes a value in the bf16 form: 2, or 4 for the fp32
    normalised maps): kernel C's group_stem plan ``conv_plan(form, groups,
    8, d, h, w, 1)`` (its chunks and cluster split, so the same sums in the
    same order) and its tile, but for the bf16 form without a cluster
    split, which takes the largest of ``MMA_TILES`` whose grid fills the
    card's SMs; with the shared memory of E's producer counted, as the C
    entry point counts it. Raises where that exceeds the card's."""
    if groups not in LOAD_WARPS:
        raise ValueError(f"volume_plan: {groups} groups")
    cpg = VOLUME_CHANNELS // groups
    conv = conv_plan(form, groups, 8, d, h, w, 1)
    if form != "fp32" and conv.cluster == 1:
        conv = next((p for p in (conv_layout(form, groups, 8, d, h, w, 1,
                                             tile, 1) for tile in MMA_TILES)
                     if p.blocks >= SMS), conv)
    _, th, td = conv.tile
    sd, sh = td + 2, th + 2
    if form == "fp32":
        sub = min(cpg, FP32_SUB)
        sw = 34
        slab = _cdiv(sd * sh * sw, 4) * 4
        desc = _cdiv(sub * sh * (2 * sw + sd - 1), 4) * 4
        loop = 4 * (_cdiv(groups, conv.cluster) * 27 * 8 + 2 * slab
                    + 2 * desc)
        partial = 4 * 8 * 32 * th * td if conv.cluster > 1 else 0
        plan = VolumePlan(conv, groups, max(loop, partial),
                          th * FP32_BUILD[groups], sub, 4 * 2 * desc)
    else:
        kc, sw = conv.k_chunk, 18
        row = 2 * kc
        stage = row * sd * sh * sw + row * 27 * 9
        units = _cdiv(groups, kc)
        nbuf = 2 if _cdiv(units, conv.cluster) > 1 else 1
        desc = _cdiv(min(kc, groups) * cpg * sh * (2 * sw + sd - 1)
                     * desc_bytes, 16) * 16
        partial = 4 * 8 * (16 * th * td + 4)
        plan = VolumePlan(conv, groups, max(nbuf * stage + desc, partial),
                          LOAD_WARPS[groups], 0, desc)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"volume_plan: {plan.smem} bytes of shared memory")
    return plan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _volume_fn():
    lib = _build.load("fused_volume_agg")
    fn = lib.volume_group_stem
    fn.argtypes = [_P] * 8
    fn.restype = _I
    return fn


def volume_stem_agg(ref: torch.Tensor, tgt: torch.Tensor, consts: dict,
                    max_disp: int, num_groups: int, approximate: bool,
                    normalize: bool = False, steps: bool = False):
    """Descriptors (B, C, H, W) x 2 -> (B, 8, D, H, W), the same as
    ``stem_agg(correlation_volume(ref, tgt, D, G, normalize))``, with
    ``D = max_disp``: kernel E on CUDA tensors (the (B, G, D, H, W) volume
    is never allocated), the plain version on CPU tensors. Kernel E takes
    C=64 with G=32 (gwc) or G=1 (norm-correlation), with or without
    ``normalize``; it never falls back to B + C. fp32 descriptors take
    fp32 ``consts`` and give fp32; bf16 ones (the bf16 form) take
    ``prepare_consts(..., low_precision=True)`` and give bf16. With
    ``steps`` (for a check; the model never asks) ``(group_stem's output,
    the output)``."""
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
    if ref.dtype != tgt.dtype:
        raise TypeError(f"volume_stem_agg: {ref.dtype} and {tgt.dtype}")
    form = "bf16" if ref.dtype == torch.bfloat16 else "fp32"
    if _low_precision(consts) != (form == "bf16"):
        raise TypeError(f"volume_stem_agg: {ref.dtype} descriptors with "
                        f"{consts['w1'].dtype} weights")
    if not on_cuda("volume_stem_agg", ref, tgt, *consts.values(),
                   dtypes=(torch.float32, torch.bfloat16)):
        if steps:
            return _stem_agg_steps(correlation.correlation_volume_plain(
                ref, tgt, max_disp, num_groups, normalize), consts,
                approximate)
        return volume_stem_agg_plain(ref, tgt, consts, max_disp, num_groups,
                                     approximate, normalize)
    correlation.check_kernel_form("volume_stem_agg", c, num_groups)
    if normalize:
        ref, tgt = correlation.l2_normalize_pair(ref, tgt, num_groups)
    # the kernel's form code: fp32; bf16 descriptors; fp32 normalised maps
    # of bf16 descriptors
    code = 0 if form == "fp32" else (2 if normalize else 1)
    dtype = torch.float32 if form == "fp32" else torch.bfloat16
    # the fp32 form's weights carry the BN scale; it takes no scale
    scale = None if form == "fp32" else consts["s1"].data_ptr()
    ints = _volume_ints(form, num_groups, max_disp, h, w,
                        ref.element_size(), b, code, bool(approximate))
    y = torch.empty((b, 8, max_disp, h, w), device=ref.device, dtype=dtype)
    err = _volume_fn()(ref.data_ptr(), tgt.data_ptr(), consts["w1"].data_ptr(),
                       scale, consts["t1"].data_ptr(), y.data_ptr(), ints[0],
                       stream_handle(ref))
    _build.check(err, "volume_stem_agg")
    if form == "fp32":
        out = conv3d_bn_gelu(y, consts["w2"], consts["t2"], 1, approximate)
    else:
        out = conv3d_bn_gelu_bf16(y, consts["w2"], consts["s2"], consts["t2"],
                                  dtype, approximate)
    count_launch(volume_stem_agg, form)
    return (y, out) if steps else out


@functools.lru_cache(maxsize=None)
def _volume_ints(form: str, groups: int, d: int, h: int, w: int,
                 desc_bytes: int, batch: int, code: int,
                 approximate: bool) -> tuple:
    """The C entry point's plan argument for one call signature: the
    address of ``volume_plan(...).ints``, and the array (kept alive
    here)."""
    ints = volume_plan(form, groups, d, h, w, desc_bytes).ints(
        batch, code, approximate)
    return ctypes.addressof(ints), ints


volume_stem_agg.launches = 0
volume_stem_agg.form_launches = {}
