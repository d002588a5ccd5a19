"""Kernel F: the stem_2 + stem_4 matching towers (``csrc/fused_stems.cu``).

Replaces ``esmstereo_tpu/ops/pallas/fused_stems.py::fused_stems_apply``.
Each StemBlock is a 3x3 stride-2 conv + BN + GELU, then a 3x3 conv + BN +
ReLU; stem_2 takes 3 -> C2 channels, stem_4 C2 -> C4, with (C2, C4) one
of ``WIDTHS``: (32, 48) in ESMStereo-L and -M, (16, 24) in -S.
``prepare_consts`` folds the eval BatchNorms into the four conv weights, as
``prepare_stems_consts`` there does (``:79``); the TPU's block-diagonal
matrices and lane packing are not ported. The weights are kept in the
kernel's ``(CI, 3, 3, CO)`` order, and the plain version reads that order
too, so the CPU tests exercise it.

The deploy form (``prepare_consts(..., low_precision=True)``) rounds
where the TPU kernel rounds: its matmul operands are bf16 whatever the
model's dtype (``fused_stems.py:74,200-280`` there), so the BN-folded
weights are rounded to bf16, and each conv's input too (the fp32 image,
the GELU output of conv_down, stem_2's output as stem_4's input); the sums
and the shifts are fp32; stem_2 and stem_4 are written in bf16, as the JAX
model casts them at the deploy numerics (``esmstereo.py:563-567``). The
image stays fp32 in both forms.

On CUDA a call launches two kernels, one per StemBlock, each with its
conv_down map in shared memory only; it counts as one launch, by form in
``form_launches``. Both forms run both convs of a StemBlock as implicit
GEMMs on the tensor cores (``mma.sync``, fp32 sums) in one kernel: the
fp32 form on fp32 operands in 3xTF32 (each operand split into two TF32
parts, three products of the four), the deploy form on bf16 operands.
Each StemBlock launches as ``stem_plan`` lays it out (its tile of output
pixels, its shared memory), which the C entry point checks against its
own count. H and W must be multiples of 4 (the model pads to /32);
anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.blocks import fold_bn
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)
from esmstereo_tpu_torch.ops.kernels.activations import gelu

_P = ctypes.c_void_p
_I = ctypes.c_int
_KEYS = ("wd2", "td2", "wc2", "tc2", "wd4", "td4", "wc4", "tc4")
# (C2, C4): the stems' widths the kernel has an instance for
WIDTHS = frozenset({(32, 48), (16, 24)})
# the forms: "fp32" (fp32 operands in 3xTF32) and "bf16" (the deploy form)
FORMS = ("fp32", "bf16")
# each form's tile of output pixels (rows, columns) of each StemBlock
# (CI -> C) of ``WIDTHS``: of (8, 32) and (8, 16), the faster on the H100
# at 544 x 992 (device time, both eyes). The deploy form: L's stem_2
# 0.1210 against 0.1291 ms, its stem_4 0.0862 against 0.0893; S's 0.0565
# against 0.0736 and 0.0275 against 0.0331. The fp32 form
# (``eval/conv_repeat.py --bf-plans``): L's stem_2 0.1713 against 0.1852,
# S's 0.0754 against 0.0824 and its stem_4 0.0669 against 0.0686 at (8,
# 32); L's stem_4 only (8, 16), the one tile at which two of its blocks
# share an SM.
STEM_TILES = {("fp32", 3, 32): (8, 32), ("fp32", 32, 48): (8, 16),
              ("fp32", 3, 16): (8, 32), ("fp32", 16, 24): (8, 16),
              ("bf16", 3, 32): (8, 32), ("bf16", 32, 48): (8, 16),
              ("bf16", 3, 16): (8, 16), ("bf16", 16, 24): (8, 16)}
# the kernel's instances (form, CI, C, rows, columns), the same list as
# ``csrc/fused_stems.cu``'s ``STEM_INSTANCES``
STEM_INSTANCES = frozenset((*key, *tile) for key, tile in STEM_TILES.items())


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stem_smem(ci: int, c: int, th: int, tw: int, form: str = "bf16") -> int:
    """Bytes of shared memory of one StemBlock's kernel in ``form``
    (``StemTile`` in the source), in rows of 32 bytes, 16 bf16 or 8 fp32
    channels each: the conv_down map of the tile's (th + 2) x (tw + 2)
    halo pixels in chunks of a row; the larger of conv_down's input with
    its weights of one chunk and the output tile; in the deploy form the
    conv's weights beside them. The fp32 form keeps each weight twice, its
    high and low TF32 parts, and passes the conv's weights through that
    region, as many chunks at a time as it holds (at least one)."""
    kc, wb = (16, 1) if form == "bf16" else (8, 2)
    np_, ck = 8 * _cdiv(c, 8), _cdiv(c, kc)
    mp = (th + 2) * (tw + 2)
    if ci == 3:     # the im2col rows and all the weights, 32 (tap, channel)
        down = 32 // kc * (mp + wb * np_) * 32
    else:           # the stride-2 window of a chunk, its weights
        down = ((2 * (th + 2) + 1) * (2 * (tw + 2) + 1) * 32
                + wb * 9 * np_ * 32)
    region = max(down, np_ * (th * tw + 8) * 32 // kc)
    if form == "bf16":
        return ck * mp * 32 + region + ck * 9 * np_ * 32
    return ck * mp * 32 + max(region, wb * 9 * np_ * 32)


@dataclasses.dataclass(frozen=True)
class StemPlan:
    """How one StemBlock launches: ``ci`` -> ``c`` channels, ``tile``
    (rows, columns) of output pixels a block, ``smem`` its bytes of dynamic
    shared memory."""

    ci: int
    c: int
    tile: tuple
    smem: int


def stem_plan(ci: int, c: int, form: str = "bf16") -> StemPlan:
    """The plan of a StemBlock ``ci`` -> ``c`` in ``form`` at its tile of
    ``STEM_TILES``; raises ``ValueError`` for another StemBlock."""
    if (form, ci, c) not in STEM_TILES:
        raise ValueError(f"stem_plan: no instance for {ci} -> {c} in the "
                         f"{form} form")
    tile = STEM_TILES[(form, ci, c)]
    return StemPlan(ci, c, tile, stem_smem(ci, c, *tile, form))


@functools.lru_cache(maxsize=None)
def _plan_ints(c2: int, c4: int, form: str):
    """The entry point's plan argument for widths (c2, c4) in ``form``:
    its address and the array (kept alive here), stem_2's (rows, columns,
    smem) then stem_4's."""
    ints = (ctypes.c_int * 6)(*(v for plan in (stem_plan(3, c2, form),
                                                stem_plan(c2, c4, form))
                                for v in (*plan.tile, plan.smem)))
    return ctypes.addressof(ints), ints


def prepare_consts(stem_2, stem_4, low_precision: bool = False) -> dict:
    """BN-folded weights of the two ``StemBlock`` modules: ``wd*`` (conv_down)
    and ``wc*`` (conv) as ``(CI, 3, 3, CO)``, ``td*`` and ``tc*`` their
    shifts; with ``low_precision`` (the deploy form) the folded weights in
    bf16, the shifts fp32."""
    def layout(w):
        w = w.permute(1, 2, 3, 0)
        return (w.to(torch.bfloat16) if low_precision else w).contiguous()

    consts = {}
    for s, stem in (("2", stem_2), ("4", stem_4)):
        wd, td = fold_bn(stem.conv_down.conv.weight, stem.conv_down.bn)
        wc, tc = fold_bn(stem.conv.weight, stem.bn)
        consts.update({f"wd{s}": layout(wd), f"td{s}": td.contiguous(),
                       f"wc{s}": layout(wc), f"tc{s}": tc.contiguous()})
    return consts


def low_precision(consts: dict) -> bool:
    """Whether ``consts`` are the deploy form's."""
    return consts["wd2"].dtype == torch.bfloat16


def _conv(x: torch.Tensor, k: torch.Tensor, t: torch.Tensor,
          stride: int) -> torch.Tensor:
    return F.conv2d(x, k.permute(3, 0, 1, 2).to(x.dtype), t, stride=stride,
                    padding=1)


def stem_block_plain(x: torch.Tensor, consts: dict, s: str,
                     approximate: bool) -> torch.Tensor:
    """Plain PyTorch version of StemBlock ``s`` (``"2"`` or ``"4"``) of
    ``consts``: (B, CI, H, W) -> (B, C, H/2, W/2); in the deploy form each
    conv's input rounded to bf16, fp32 sums, and the output in bf16."""
    low = low_precision(consts)

    def operand(t):
        return t.to(torch.bfloat16).float() if low else t

    x = gelu(_conv(operand(x), consts[f"wd{s}"], consts[f"td{s}"], 2),
             approximate)
    x = F.relu(_conv(operand(x), consts[f"wc{s}"], consts[f"tc{s}"], 1))
    return x.to(torch.bfloat16) if low else x


def stems_plain(img: torch.Tensor, consts: dict, approximate: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (B, 3, H, W) -> (stem_2 out (B, C2, H/2, W/2),
    stem_4 out (B, C4, H/4, W/4)); in the deploy form each conv's input
    rounded to bf16, fp32 sums, and both outputs in bf16."""
    s2 = stem_block_plain(img, consts, "2", approximate)
    return s2, stem_block_plain(s2, consts, "4", approximate)


def widths(consts: dict) -> tuple[int, int]:
    """(C2, C4) of ``consts``; raises ``ValueError`` unless it is one of
    ``WIDTHS`` and every weight has its shape."""
    c2, c4 = consts["td2"].shape[0], consts["td4"].shape[0]
    if (c2, c4) not in WIDTHS:
        raise ValueError(f"stems: widths {(c2, c4)}, the kernel takes "
                         f"{sorted(WIDTHS)}")
    for s, (ci, co) in (("2", (3, c2)), ("4", (c2, c4))):
        want = {f"wd{s}": (ci, 3, 3, co), f"td{s}": (co,),
                f"wc{s}": (co, 3, 3, co), f"tc{s}": (co,)}
        for k, shape in want.items():
            if tuple(consts[k].shape) != shape:
                raise ValueError(f"stems: {k} {tuple(consts[k].shape)}, the "
                                 f"kernel takes {shape}")
    return c2, c4


def _check(img: torch.Tensor, consts: dict) -> tuple[int, int]:
    if img.ndim != 4 or img.shape[1] != 3 or img.shape[2] % 4 \
            or img.shape[3] % 4 or img.shape[2] == 0 or img.shape[3] == 0:
        raise ValueError(f"stems: image {tuple(img.shape)}; the kernel takes "
                         f"(B, 3, H, W) with H and W multiples of 4")
    return widths(consts)


@functools.cache
def _fn():
    fn = _build.load("fused_stems").fused_stems
    fn.argtypes = [_P] * 11 + [_I] * 6 + [_P, _I, _P]
    fn.restype = _I
    return fn


def stems(img: torch.Tensor, consts: dict, approximate: bool
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, H, W) fp32 -> ((B, C2, H/2, W/2), (B, C4, H/4, W/4)), fp32 or,
    with the deploy form's ``consts``, bf16: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    c2, c4 = _check(img, consts)
    low = low_precision(consts)
    for k in _KEYS:
        want = torch.bfloat16 if low and k[0] == "w" else img.dtype
        if consts[k].dtype != want:
            raise TypeError(f"stems: {k} is {consts[k].dtype}, the "
                            f"{'deploy' if low else img.dtype} form takes "
                            f"{want}")
    if not on_cuda("stems", img, *(consts[k] for k in _KEYS),
                   dtypes=(torch.float32, torch.bfloat16)):
        return stems_plain(img, consts, approximate)
    if img.dtype != torch.float32:
        raise TypeError(f"stems: the kernel takes an fp32 image, not "
                        f"{img.dtype}")
    b, _, h, w = img.shape
    form = "bf16" if low else "fp32"
    out = torch.bfloat16 if low else torch.float32
    s2 = torch.empty((b, c2, h // 2, w // 2), device=img.device, dtype=out)
    s4 = torch.empty((b, c4, h // 4, w // 4), device=img.device, dtype=out)
    err = _fn()(img.data_ptr(), *(consts[k].data_ptr() for k in _KEYS),
                s2.data_ptr(), s4.data_ptr(), b, h, w, c2, c4, int(low),
                _plan_ints(c2, c4, form)[0], int(approximate),
                stream_handle(img))
    _build.check(err, "stems")
    count_launch(stems, form)
    return s2, s4


stems.launches = 0
stems.form_launches = {}
