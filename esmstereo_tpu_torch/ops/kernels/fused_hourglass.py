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

On CUDA a down level launches two kernels (k3 s2, then k3 s1). An up
level launches three in fp32 (the transposed conv, the 1x1x1 conv over
``[up | skip]``, the k3 s1 conv) with the intermediates in device memory,
and two in its deploy form: ``up_cat_bf16``, the transposed conv and the
1x1x1 conv in one launch on the tensor cores, whose ``up`` never leaves
the chip (as the TPU kernel keeps it, ``:585,616-622`` there), then the k3
conv. Each wrapper call counts as one launch (``form_launches`` by
``"fp32"`` and ``"bf16"``); ``up_cat_bf16`` counts its own.
The k3 convs (``conv3d_bn_gelu``, ``conv3d_bn_gelu_bf16``; kernels C and E
launch them too) run as ``conv_plan`` lays them out: all of CO in one block
(up to 72 channels), the largest tile whose grid fills the card's 132 SMs,
and where none does the input channels split over a thread-block cluster;
the deploy form on the tensor cores, the fp32 form as FMA. Any width runs
(L's 24, 40, 72; M's 16, 24, 40; S's 12, 16, 24); the fp32 transposed and
1x1x1 convs tile output channels by 8 and mask the last tile, the 1x1x1
conv at most 128 output channels; ``up_cat_bf16`` takes the up levels'
widths of L, M and S (``UP_N_TILES``: 9 to 16, 17 to 24 and 33 to 40
output channels) as ``up_plan`` lays them out. The two conv wrappers call
the operators ``esmstereo::conv3d_bn_gelu`` and ``::conv3d_bn_gelu_bf16``
(``torch_ops.py``) with ``conv_plan``'s ints: on CUDA tensors their
kernels in ``csrc/torch_ops.cpp`` launch this source's conv, on CPU
tensors their CPU kernels are the plain versions (``conv3d_bn_gelu_plain``,
``conv3d_bn_gelu_bf16_plain``), so kernel C's wrapper takes one route on
both devices. The other launches of this source stay ctypes calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import bn_scale_shift, fold_bn
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             refuse_autograd, stream_handle,
                                             torch_ops)
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
    z = up_cat_plain(src, skip, consts, approximate)
    y = F.conv3d(z.float(), consts["w3"].float(), padding=1)
    return _bn_gelu(y, consts, "3", approximate).to(torch.bfloat16)


def up_cat_plain(src: torch.Tensor, skip: torch.Tensor, consts: dict,
                 approximate: bool) -> torch.Tensor:
    """Plain PyTorch version of an up level's deploy form's first step
    (``up_cat_bf16``): the transposed conv cropped to the skip's (D, H, W),
    BN, GELU, bf16; then the 1x1x1 conv over ``[up | skip]``, BN, GELU,
    bf16."""
    d2, h2, w2 = skip.shape[2:]
    up = F.conv_transpose3d(src.float(), consts["wu"].float(), stride=2,
                            padding=1)[:, :, :d2, :h2, :w2]
    up = _bn_gelu(up, consts, "u", approximate).to(torch.bfloat16)
    z = F.conv3d(torch.cat([up, skip], dim=1).float(), consts["wc"].float())
    return _bn_gelu(z, consts, "c", approximate).to(torch.bfloat16)


# --- the launch plan of the conv3d k3 p1 -------------------------------------

SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448           # dynamic shared memory a block may use (227 KB)
MAX_CLUSTER = 8             # the portable thread-block cluster size
# the fp32 kernel's tiles, (h rows, d depths) of 32 columns, largest first,
# and its most threads a block (32 x rows x channel groups); a tile is large
# enough when its grid has a wave of blocks and FP32_WARPS warps, and a
# smaller grid splits its channels until it has FP32_SPLIT_WARPS (fitted
# to the device times of every tile and split at each L, M and S conv on
# the H100: ``python3 -m esmstereo_tpu_torch.eval.conv_sweep``)
FP32_TILES = ((4, 8), (2, 4), (1, 4))
FP32_MAX_THREADS = 512
FP32_MAX_GROUPS = 9
FP32_WARPS = 600
FP32_SPLIT_WARPS = 2400
# the MMA kernel's tiles, (h rows, d depths) of 16 columns, largest first;
# its n-tile instances (8 output channels each), 4 consumer warps, and its
# chunks of input channels: 16, or 8 where CI <= 8 (up to 3 n-tiles)
MMA_TILES = ((4, 4), (4, 2), (2, 2))
MMA_N_TILES = (1, 2, 3, 5, 9)
MMA_WARPS = 4
# each form's (input, output) dtype codes at the C entry points and the
# n-tile instances of its MMA kernel: every one with bf16 in and out, one
# for C's other deploy forms (the int8 volume, the fp32 output)
FORMS = {"fp32": (2, 2, None), "bf16": (0, 0, MMA_N_TILES),
         "bf16_fp32": (0, 1, (1,)), "int8_bf16": (1, 0, (1,)),
         "int8_fp32": (1, 1, (1,))}
# the MMA kernel's instances, (form, stride, n-tiles, channels a chunk),
# each with every tile ``conv_tiles`` gives it: the convs of L, M and S
# (``models/esmstereo.py::conv3d_shapes``) in the forms their callers
# launch, and int8 -> fp32 on C's first convs; the same list as
# ``csrc/fused_hourglass.cu``'s ``MMA_INSTANCES``
MMA_INSTANCES = frozenset({
    ("bf16", 1, 1, 8), ("bf16", 1, 1, 16), ("bf16", 1, 2, 16),
    ("bf16", 1, 3, 16), ("bf16", 1, 5, 16), ("bf16", 1, 9, 16),
    ("bf16", 2, 2, 8), ("bf16", 2, 3, 8), ("bf16", 2, 2, 16),
    ("bf16", 2, 3, 16), ("bf16", 2, 5, 16), ("bf16", 2, 9, 16),
    ("bf16_fp32", 1, 1, 8), ("int8_bf16", 1, 1, 8), ("int8_bf16", 1, 1, 16),
    ("int8_fp32", 1, 1, 8), ("int8_fp32", 1, 1, 16)})
# the conv shapes of L, M and S (batch 1, a 544 x 992 frame) whose fastest
# tile and split on the H100, by at least 5%, is not the rule's (device
# time of each, ``python3 -m esmstereo_tpu_torch.eval.conv_sweep``), among
# those that keep a wave of blocks or every split the channels allow:
# (form, ci, co, d, h, w, stride) -> ((rows, depths), cluster)
TUNED = {("fp32", 40, 40, 12, 34, 62, 1): ((2, 4), 8),      # L, G2 s1
         ("fp32", 32, 8, 24, 68, 124, 1): ((4, 8), 4),      # M, group_stem
         ("fp32", 24, 40, 6, 17, 31, 2): ((1, 4), 8),       # M, G3 s2
         ("fp32", 40, 40, 3, 9, 16, 1): ((1, 4), 8),        # M, G3 s1
         ("fp32", 16, 24, 3, 9, 16, 2): ((1, 4), 8),        # S, G3 s2
         ("fp32", 24, 24, 2, 5, 8, 1): ((1, 4), 8),         # S, G3 s1
         ("bf16", 8, 24, 48, 136, 248, 2): ((2, 2), 1),     # L, G1 s2
         ("bf16", 40, 72, 12, 34, 62, 2): ((4, 2), 3),      # L, G3 s2
         ("bf16", 72, 72, 6, 17, 31, 1): ((4, 2), 4),       # L, G3 s1
         ("bf16", 32, 8, 12, 34, 62, 1): ((4, 2), 2)}       # S, group_stem


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How one conv3d k3 p1 launches (``csrc/fused_hourglass.cu``).

    ``conv`` is ``(ci, co, d, h, w, stride)``; ``tile`` a block's output
    voxels (w, h, d); ``groups`` its channel tiles of 8 (the fp32 kernel's
    warp groups, the MMA kernel's n-tiles), ``co_blocks`` how many blocks
    share CO; ``cluster`` the blocks of one cluster that split the input
    channels, in units of ``k_chunk`` (1 for the fp32 kernel, the MMA
    kernel's chunks of 8 or 16), ``ranks`` each rank's channel range;
    ``blocks`` the grid's blocks at batch 1, ``threads`` a block's,
    ``smem`` a block's dynamic shared memory in bytes."""

    form: str
    conv: tuple
    tile: tuple
    groups: int
    co_blocks: int
    cluster: int
    ranks: tuple
    blocks: int
    threads: int
    smem: int
    k_chunk: int

    def ints(self, batch: int, approximate: bool) -> ctypes.Array:
        """The C entry points' plan argument: 16 ints (B, CI, CO, D, H, W,
        stride, in_type, out_type, tile_h, tile_d, groups, cluster, smem,
        approximate, k_chunk)."""
        return (ctypes.c_int * 16)(
            batch, *self.conv, *FORMS[self.form][:2], *self.tile[1:],
            self.groups, self.cluster, self.smem, int(approximate),
            self.k_chunk)


def _channels(form: str, ci: int, co: int) -> tuple:
    """A form's channel tiles of 8 a block, its CO blocks and its chunk of
    input channels."""
    if form not in FORMS or min(ci, co) < 1:
        raise ValueError(f"conv_plan: {form}, {ci} -> {co}")
    if form == "fp32":
        needed = _cdiv(co, 8)
        co_blocks = _cdiv(needed, FP32_MAX_GROUPS)
        return _cdiv(needed, co_blocks), co_blocks, 1
    n_tiles = FORMS[form][2]
    need = min(_cdiv(co, 8), max(n_tiles))
    groups = min(t for t in n_tiles if t >= need)
    return groups, _cdiv(co, 8 * groups), 8 if ci <= 8 and groups <= 3 else 16


def conv_tiles(form: str, ci: int, co: int, stride: int) -> list:
    """The (rows, depths) tiles, largest first, that the kernels have for a
    conv: the fp32 kernel's up to its most threads; the MMA kernel's (4, 4)
    only at stride 1, up to 3 n-tiles and in chunks of 8 channels (with 16
    it ran 21-26% slower than (4, 2) on the H100), and any tile up to 18
    m-tile x n-tile products a warp (72 fp32 sums a thread)."""
    groups, _, k_chunk = _channels(form, ci, co)
    if form == "fp32":
        return [t for t in FP32_TILES
                if 32 * t[0] * groups <= FP32_MAX_THREADS]
    return [t for t in MMA_TILES
            if t[0] * t[1] // MMA_WARPS * groups <= 18
            and (t != (4, 4)
                 or (stride == 1 and groups <= 3 and k_chunk == 8))]


def conv_layout(form: str, ci: int, co: int, d: int, h: int, w: int,
                stride: int, tile: tuple, cluster: int) -> ConvPlan:
    """The plan of a conv launched with ``tile`` (rows, depths) and
    ``cluster`` blocks splitting its input channels."""
    if stride not in (1, 2):
        raise ValueError(f"conv_plan: stride {stride}")
    groups, co_blocks, k_chunk = _channels(form, ci, co)
    if form != "fp32" and (form, stride, groups,
                           k_chunk) not in MMA_INSTANCES:
        raise ValueError(f"conv_plan: no MMA instance for {form} {ci} -> "
                         f"{co} at stride {stride} ({groups} n-tiles, "
                         f"chunks of {k_chunk})")
    th, td = tile
    tile_w = 32 if form == "fp32" else 16
    do, ho, wo = ((n - 1) // stride + 1 for n in (d, h, w))
    blocks = (_cdiv(wo, tile_w) * _cdiv(ho, th) * _cdiv(do, td) * co_blocks
              * cluster)
    sd, sh = stride * (td - 1) + 3, stride * (th - 1) + 3
    sw = stride * (tile_w - 1) + 3
    voxels = tile_w * th * td
    np_ = 8 * groups
    units = _cdiv(ci, k_chunk)
    if form == "fp32":
        stage = 4 * (_cdiv(sd * sh * sw, 4) * 4 + 27 * np_)
        smem = max(2 * stage, 4 * np_ * voxels if cluster > 1 else 0)
        threads = 32 * th * groups
    else:
        # the slab and a tap's np_ weight rows padded by one, k_chunk bf16
        # values a row
        row = 2 * k_chunk
        stage = row * sd * sh * sw + row * 27 * (np_ + 1)
        nbuf = 2 if _cdiv(units, cluster) > 1 else 1
        smem = max(nbuf * stage, 4 * np_ * (voxels + 4))
        threads = 32 * (MMA_WARPS + (8 if groups >= 5 else 4))
    ranks = tuple((min(ci, k_chunk * (r * units // cluster)),
                   min(ci, k_chunk * ((r + 1) * units // cluster)))
                  for r in range(cluster))
    return ConvPlan(form, (ci, co, d, h, w, stride), (tile_w, th, td),
                    groups, co_blocks, cluster, ranks, blocks, threads, smem,
                    k_chunk)


@functools.lru_cache(maxsize=None)
def conv_plan(form: str, ci: int, co: int, d: int, h: int, w: int,
              stride: int) -> ConvPlan:
    """The launch plan of a conv3d k3 p1 of ``ci -> co`` channels on a
    ``(d, h, w)`` input at ``stride`` 1 or 2, in ``form`` (``FORMS``:
    ``"fp32"``, or a deploy form named by its input and output dtypes).
    The largest tile whose grid fills the card's SMs (and, in fp32, holds
    ``FP32_WARPS`` warps); where none does, the input channels split over a
    cluster of up to ``MAX_CLUSTER`` blocks (at most one rank per channel,
    or per chunk of the MMA kernel; in fp32 by powers of two until the grid
    holds ``FP32_SPLIT_WARPS`` warps); ``TUNED``'s where it has the shape."""
    tiles = conv_tiles(form, ci, co, stride)

    def layout(tile, cluster=1):
        return conv_layout(form, ci, co, d, h, w, stride, tile, cluster)

    tuned = TUNED.get((form, ci, co, d, h, w, stride))
    if tuned:
        return layout(*tuned)

    for tile in tiles:
        plan = layout(tile)
        if plan.blocks >= SMS and (form != "fp32" or plan.blocks
                                   * plan.threads >= 32 * FP32_WARPS):
            return plan
    if form == "fp32":
        plan = layout((2, 4) if (2, 4) in tiles else tiles[-1])
        cluster = 1
        while (2 * cluster <= min(MAX_CLUSTER, ci)
               and (plan.blocks * cluster < SMS or plan.blocks * cluster
                    * plan.threads < 32 * FP32_SPLIT_WARPS)):
            cluster *= 2
        return layout(plan.tile[1:], cluster)
    plan = layout(tiles[-1])
    units = _cdiv(ci, plan.k_chunk)
    return layout(tiles[-1], min(MAX_CLUSTER, units,
                                 _cdiv(SMS, plan.blocks)))


# --- the launch plan of H's fused deploy kernel ------------------------------

# its tiles, (rows, depths) of 16 columns of the half-resolution grid (all
# 8 output parity classes: 32 x 2 rows x 2 depths output voxels), largest
# first; its n-tile instances (L's up levels 40 and 24 output channels,
# M's 24 and 16, S's 16 and 12); the most m-tile x n-tile products a warp
# keeps (48 fp32 sums a thread)
UP_TILES = ((2, 2), (2, 1), (1, 1))
UP_N_TILES = (2, 3, 5)
UP_MAX_SUMS = 12
# a tile is large enough when its grid holds this many blocks, 3/4 of the
# card's SMs (on the H100 the larger tile won where its grid held 108
# blocks, 82% of the SMs: L's first up level, M's second)
UP_FILL = 3 * SMS // 4
# the kernel's instances, (n-tiles, rows, depths): every tile of
# ``UP_TILES`` within ``UP_MAX_SUMS`` for each n-tile count; the same list
# as ``csrc/fused_hourglass.cu``'s ``UP_INSTANCES``
UP_INSTANCES = frozenset((nt, th, td) for nt in UP_N_TILES
                         for th, td in UP_TILES if th * td * nt <= UP_MAX_SUMS)


def up_smem(n_tiles: int, th: int, td: int) -> int:
    """Bytes of shared memory of H's fused kernel (``UpTile`` in the
    source): the larger of the loop's slab of one chunk of 16 input
    channels plus its weights [64 taps][8 n-tiles][16], and the
    epilogue's skip tile plus the 1x1x1 conv's weights."""
    np_, ck = 8 * n_tiles, _cdiv(n_tiles, 2)
    loop = (td + 2) * (th + 2) * 18 * 32 + 64 * np_ * 32
    epilogue = ck * 8 * th * td * 16 * 32 + 2 * ck * np_ * 32
    return max(loop, epilogue)


@dataclasses.dataclass(frozen=True)
class UpPlan:
    """How ``up_cat_bf16`` launches (``csrc/fused_hourglass.cu``).

    ``shape`` is ``(ci, co, ds, hs, ws, d2, h2, w2)``; ``tile`` a block's
    (rows, depths) of 16 columns of the half-resolution grid;
    ``n_tiles`` its output channels' n-tiles of 8; ``blocks`` the grid's
    blocks at batch 1; ``smem`` a block's dynamic shared memory in
    bytes."""

    shape: tuple
    n_tiles: int
    tile: tuple
    blocks: int
    smem: int

    def ints(self, batch: int, approximate: bool) -> ctypes.Array:
        """The C entry point's plan argument: 14 ints (B, CI, CO, Ds, Hs,
        Ws, D2, H2, W2, n_tiles, tile_h, tile_d, smem, approximate)."""
        return (ctypes.c_int * 14)(batch, *self.shape, self.n_tiles,
                                   *self.tile, self.smem, int(approximate))


def up_layout(ci: int, co: int, ds: int, hs: int, ws: int, d2: int, h2: int,
              w2: int, tile: tuple) -> UpPlan:
    """The plan of ``up_cat_bf16`` launched with ``tile``."""
    n_tiles = _cdiv(co, 8)
    th, td = tile
    if (n_tiles, th, td) not in UP_INSTANCES or min(ci, co) < 1:
        raise ValueError(f"up_plan: no instance for {ci} -> {co} at tile "
                         f"{tile} ({n_tiles} n-tiles)")
    if not (0 < d2 <= 2 * ds and 0 < h2 <= 2 * hs and 0 < w2 <= 2 * ws):
        raise ValueError(f"up_plan: skip {(d2, h2, w2)} against src "
                         f"{(ds, hs, ws)}")
    blocks = _cdiv(w2, 32) * _cdiv(h2, 2 * th) * _cdiv(d2, 2 * td)
    return UpPlan((ci, co, ds, hs, ws, d2, h2, w2), n_tiles, tile, blocks,
                  up_smem(n_tiles, th, td))


@functools.lru_cache(maxsize=None)
def up_plan(ci: int, co: int, ds: int, hs: int, ws: int, d2: int, h2: int,
            w2: int) -> UpPlan:
    """The launch plan of H's fused transposed + 1x1x1 conv: ``ci`` input
    channels at ``(ds, hs, ws)`` to ``co`` at the skip's ``(d2, h2, w2)``.
    The largest tile of ``UP_TILES`` within ``UP_MAX_SUMS`` whose grid
    holds ``UP_FILL`` blocks, else the smallest; raises ``ValueError`` for
    a width without an instance."""
    n_tiles = _cdiv(co, 8)
    if n_tiles not in UP_N_TILES:
        raise ValueError(f"up_plan: {co} output channels ({n_tiles} "
                         f"n-tiles); the kernel has {UP_N_TILES}")
    tiles = [t for t in UP_TILES if t[0] * t[1] * n_tiles <= UP_MAX_SUMS]
    for tile in tiles:
        plan = up_layout(ci, co, ds, hs, ws, d2, h2, w2, tile)
        if plan.blocks >= UP_FILL:
            return plan
    return up_layout(ci, co, ds, hs, ws, d2, h2, w2, tiles[-1])


@functools.lru_cache(maxsize=None)
def _up_ints(b: int, shape: tuple, approximate: bool):
    """``up_plan``'s ints for one call signature: their address and the
    array (kept alive here)."""
    ints = up_plan(*shape).ints(b, approximate)
    return ctypes.addressof(ints), ints


@functools.cache
def _fns():
    lib = _build.load("fused_hourglass")
    deconv = lib.hourglass_deconv
    deconv.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [_P]
    cat = lib.hourglass_conv1x1_cat
    cat.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    up_cat = lib.hourglass_up_cat_bf16
    up_cat.argtypes = [_P] * 11
    for fn in (deconv, cat, up_cat):
        fn.restype = _I
    return deconv, cat, up_cat


@functools.lru_cache(maxsize=None)
def conv_ints(form: str, b: int, ci: int, co: int, d: int, h: int, w: int,
              stride: int, approximate: bool) -> tuple:
    """The conv operators' ``plan`` argument for one call signature:
    ``conv_plan``'s 16 ints (``ConvPlan.ints``)."""
    return tuple(conv_plan(form, ci, co, d, h, w, stride).ints(b,
                                                               approximate))


def conv3d_bn_gelu_plain(x: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                         stride: int, approximate: bool) -> torch.Tensor:
    """Plain version of the fp32 conv: conv3d k3 p1 with the folded shift
    as its bias, then GELU."""
    return gelu(F.conv3d(x, w, t, stride=stride, padding=1), approximate)


def conv3d_bn_gelu_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, shift: torch.Tensor,
                              out_dtype: torch.dtype, approximate: bool,
                              stride: int = 1) -> torch.Tensor:
    """Plain version of the deploy forms: the conv on the operands widened
    to fp32 (bf16 or int8 input, bf16 weights), the BN after the sum, GELU,
    one rounding to ``out_dtype``."""
    y = F.conv3d(x.float(), w.float(), stride=stride, padding=1)
    return bn_gelu(y, scale, shift, approximate).to(out_dtype)


def _conv_shape(x: torch.Tensor, w: torch.Tensor, stride: int) -> tuple:
    b, _, d, h, wd = x.shape
    return (b, w.shape[0], *((n - 1) // stride + 1 for n in (d, h, wd)))


def _conv_op_plain(x, w, t, stride, approximate, plan):
    """``esmstereo::conv3d_bn_gelu``'s CPU kernel."""
    return conv3d_bn_gelu_plain(x, w, t, stride, approximate)


def _conv_op_fake(x, w, t, stride, approximate, plan):
    return x.new_empty(_conv_shape(x, w, stride))


def _conv_bf16_op_plain(x, w, scale, shift, out_fp32, stride, approximate,
                        plan):
    """``esmstereo::conv3d_bn_gelu_bf16``'s CPU kernel: bf16 out, or fp32
    with ``out_fp32``."""
    return conv3d_bn_gelu_bf16_plain(x, w, scale, shift,
                                     _conv_out_dtype(out_fp32), approximate,
                                     stride)


def _conv_bf16_op_fake(x, w, scale, shift, out_fp32, stride, approximate,
                       plan):
    if x.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"conv3d bf16: takes bf16 or int8, not {x.dtype}")
    return x.new_empty(_conv_shape(x, w, stride),
                       dtype=_conv_out_dtype(out_fp32))


def _conv_out_dtype(out_fp32: bool) -> torch.dtype:
    return torch.float32 if out_fp32 else torch.bfloat16


torch_ops.register("conv3d_bn_gelu", _conv_op_plain, _conv_op_fake)
torch_ops.register("conv3d_bn_gelu_bf16", _conv_bf16_op_plain,
                   _conv_bf16_op_fake)


def conv3d_bn_gelu(x: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                   stride: int, approximate: bool) -> torch.Tensor:
    """The fp32 conv3d k3 p1 (stride 1 or 2) + folded BN + GELU through
    ``esmstereo::conv3d_bn_gelu``: one launch on CUDA tensors, as
    ``conv_plan("fp32", ...)`` lays it out (the conv of kernels C, E, G
    and H), the plain version on CPU tensors. ``w`` is ``(CO, CI, 3, 3,
    3)`` with the BN scale folded in, ``t`` the shift."""
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if w.shape != (co, ci, 3, 3, 3) or t.shape != (co,):
        raise ValueError(f"conv3d: weight {tuple(w.shape)} for {ci} inputs")
    card = on_cuda("conv3d", x, w, t)
    plan = ()
    if card:
        plan = conv_ints("fp32", b, ci, co, d, h, wd, stride,
                         bool(approximate))
        torch_ops.load_cuda()
    y = torch_ops.op("conv3d_bn_gelu")(x, w, t, stride, bool(approximate),
                                       list(plan))
    if card:
        _count_conv(conv3d_bn_gelu, ("fp32", ci, co, d, h, wd, stride))
    return y


# the deploy forms by (input, output) dtype
_DEPLOY_FORMS = {(torch.bfloat16, torch.bfloat16): "bf16",
                 (torch.bfloat16, torch.float32): "bf16_fp32",
                 (torch.int8, torch.bfloat16): "int8_bf16",
                 (torch.int8, torch.float32): "int8_fp32"}


def conv3d_bn_gelu_bf16(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, out_dtype: torch.dtype,
                        approximate: bool, stride: int = 1) -> torch.Tensor:
    """The conv3d k3 p1 in its deploy form through
    ``esmstereo::conv3d_bn_gelu_bf16``: one launch on CUDA tensors
    (kernels C, E's agg, G and H), on the tensor cores as
    ``conv_plan(form, ...)`` lays it out, the plain version on CPU
    tensors: ``x`` bf16 or int8, ``w`` ``(CO, CI, 3, 3, 3)`` bf16 (raw, BN
    not folded), fp32 sums, then ``GELU(sum * scale + shift)`` in fp32,
    written in ``out_dtype`` (bf16 or fp32). bf16 -> bf16 takes stride 1 or
    2 and any CO; the other forms stride 1 and CO a multiple of 8."""
    b, ci, d, h, wd = x.shape
    co = w.shape[0]
    if (w.shape != (co, ci, 3, 3, 3) or scale.shape != (co,)
            or shift.shape != (co,)):
        raise ValueError(f"conv3d bf16: weight {tuple(w.shape)} for {ci} "
                         f"inputs")
    form = _DEPLOY_FORMS.get((x.dtype, out_dtype))
    if w.dtype != torch.bfloat16 or form is None:
        raise TypeError(f"conv3d bf16: {x.dtype} in, {w.dtype} weights, "
                        f"{out_dtype} out")
    if form != "bf16" and (stride != 1 or co % 8):
        raise ValueError(f"conv3d bf16: {x.dtype} -> {out_dtype} takes "
                         f"stride 1 and CO a multiple of 8; got stride "
                         f"{stride}, CO {co}")
    card = on_cuda("conv3d bf16", x, w, scale, shift,
                   dtypes=(torch.bfloat16, torch.int8, torch.float32))
    plan = ()
    if card:
        plan = conv_ints(form, b, ci, co, d, h, wd, stride,
                         bool(approximate))
        torch_ops.load_cuda()
    y = torch_ops.op("conv3d_bn_gelu_bf16")(
        x, w, scale, shift, out_dtype == torch.float32, stride,
        bool(approximate), list(plan))
    if card:
        _count_conv(conv3d_bn_gelu_bf16, (form, ci, co, d, h, wd, stride))
    return y


def _count_conv(wrapper, key: tuple) -> None:
    """One launch of a conv wrapper's kernel: by form, and by ``key``
    (``conv_plan``'s arguments) in ``wrapper.shape_launches``."""
    count_launch(wrapper, key[0])
    wrapper.shape_launches[key] = wrapper.shape_launches.get(key, 0) + 1


def up_cat_bf16(src: torch.Tensor, skip: torch.Tensor, consts: dict,
                approximate: bool) -> torch.Tensor:
    """One launch of H's deploy form's transposed conv and 1x1x1 conv on
    CUDA tensors (``up_cat_plain``'s function), on the tensor cores as
    ``up_plan`` lays it out: bf16 src and skip, the deploy form's consts
    (raw bf16 weights, fp32 BN scales and shifts); returns z, bf16, the
    skip's shape. ``up_pair`` runs it, then the k3 conv."""
    refuse_autograd("up_cat_bf16", src, skip, *consts.values())
    b, ci, ds, hs, ws = src.shape
    co, d2, h2, w2 = skip.shape[1:]
    ints, _ = _up_ints(b, (ci, co, ds, hs, ws, d2, h2, w2), bool(approximate))
    for k in ("wu", "wc"):
        if consts[k].data_ptr() % 16:
            raise ValueError(f"up_cat_bf16: {k} is not 16-byte aligned")
    z = torch.empty_like(skip)
    err = _fns()[2](src.data_ptr(), skip.data_ptr(), consts["wu"].data_ptr(),
                    consts["su"].data_ptr(), consts["tu"].data_ptr(),
                    consts["wc"].data_ptr(), consts["sc"].data_ptr(),
                    consts["tc"].data_ptr(), z.data_ptr(), ints,
                    stream_handle(src))
    _build.check(err, "up_pair transposed + 1x1x1 conv bf16")
    count_launch(up_cat_bf16, "bf16")
    return z


up_cat_bf16.launches = 0
up_cat_bf16.form_launches = {}

for _conv in (conv3d_bn_gelu, conv3d_bn_gelu_bf16):
    _conv.launches = 0
    _conv.form_launches = {}
    _conv.shape_launches = {}


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
    if form == "bf16":
        z = up_cat_bf16(src, skip, consts, approximate)
        y = conv3d_bn_gelu_bf16(z, consts["w3"], consts["s3"], consts["t3"],
                                torch.bfloat16, approximate)
        count_launch(up_pair, form)
        return y
    if co > _MAX_CAT_CO:
        raise NotImplementedError(f"up_pair kernel takes at most "
                                  f"{_MAX_CAT_CO} channels; got {co}")
    deconv, cat, _ = _fns()
    approx = int(approximate)
    stream = stream_handle(src)
    up = torch.empty_like(skip)
    z = torch.empty_like(skip)
    err = deconv(src.data_ptr(), wu.data_ptr(), consts["tu"].data_ptr(),
                 up.data_ptr(), b, ci, co, ds, hs, ws, d2, h2, w2, approx,
                 stream)
    _build.check(err, "up_pair transposed conv")
    err = cat(up.data_ptr(), skip.data_ptr(), consts["wc"].data_ptr(),
              consts["tc"].data_ptr(), z.data_ptr(), b, co, d2 * h2 * w2,
              approx, stream)
    _build.check(err, "up_pair 1x1x1 conv")
    y = conv3d_bn_gelu(z, consts["w3"], consts["t3"], 1, approximate)
    count_launch(up_pair, form)
    return y


down_pair.launches = 0
down_pair.form_launches = {}
up_pair.launches = 0
up_pair.form_launches = {}
