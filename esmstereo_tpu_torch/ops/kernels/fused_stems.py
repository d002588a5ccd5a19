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
``form_launches``. H and W must be multiples of 4 (the model pads to
/32); anything else raises.
"""

from __future__ import annotations

import ctypes
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


def stems_plain(img: torch.Tensor, consts: dict, approximate: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (B, 3, H, W) -> (stem_2 out (B, C2, H/2, W/2),
    stem_4 out (B, C4, H/4, W/4)); in the deploy form each conv's input
    rounded to bf16, fp32 sums, and both outputs in bf16."""
    low = low_precision(consts)

    def operand(t):
        return t.to(torch.bfloat16).float() if low else t

    outs = []
    x = img
    for s in ("2", "4"):
        x = gelu(_conv(operand(x), consts[f"wd{s}"], consts[f"td{s}"], 2),
                 approximate)
        x = F.relu(_conv(operand(x), consts[f"wc{s}"], consts[f"tc{s}"], 1))
        if low:
            x = x.to(torch.bfloat16)
        outs.append(x)
    return outs[0], outs[1]


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
    fn.argtypes = [_P] * 11 + [_I] * 7 + [_P]
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
    out = torch.bfloat16 if low else torch.float32
    s2 = torch.empty((b, c2, h // 2, w // 2), device=img.device, dtype=out)
    s4 = torch.empty((b, c4, h // 4, w // 4), device=img.device, dtype=out)
    err = _fn()(img.data_ptr(), *(consts[k].data_ptr() for k in _KEYS),
                s2.data_ptr(), s4.data_ptr(), b, h, w, c2, c4, int(low),
                int(approximate), stream_handle(img))
    _build.check(err, "stems")
    count_launch(stems, "bf16" if low else "fp32")
    return s2, s4


stems.launches = 0
stems.form_launches = {}
