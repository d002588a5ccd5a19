"""Kernels B and D: the correlation cost volume (``csrc/correlation.cu``).

Replaces ``esmstereo_tpu/ops/pallas/correlation.py::correlation_volume``
(D) and ``::correlation_volume_folded`` (B) in the unfolded
``(B, G, D, H, W)`` layout: D's ``(B, D, H, W, G)`` volume with the G axis
moved, B's depth-folded one unfolded. As D, one function gives three forms:

  * ``num_groups=32, normalize=False``: group-wise correlation (gwc);
  * ``num_groups=32, normalize=True``:  gwc on L2-normalised groups;
  * ``num_groups=1,  normalize=True``:  norm-correlation.

In fp32 the products and group means are fp32. On bf16 descriptors the
volume is bf16, in the rounding of one of the two Pallas kernels
(``round_products``). Both upcast the descriptors to fp32 and, in the
normalised forms, normalise in fp32
(``esmstereo_tpu/ops/pallas/correlation.py:150-164,262-273``). Then:

  * B (``round_products=True``, the model's; ``:114-122``) rounds each
    fp32 product to bf16, sums the group's rounded products in fp32 (its
    bf16 dot against the 1/(C/G) group matrix accumulates in fp32),
    scales by 1/(C/G) and writes bf16;
  * D (``round_products=False``; ``:45-65``) sums the unrounded fp32
    products, as its fp32 HIGHEST dot does, and rounds only at the store.

``volume_form`` names the form of a call; the wrapper counts launches by
it, and the plain version dispatches by it.

On CUDA a call is one launch, laid out by ``corr_plan`` (columns and
thread rows a block, a thread a column; shared memory), which the C entry
point checks; the normalised forms normalise inside it,
with no scratch maps. The wrapper calls the operator
``esmstereo::correlation_volume`` (``torch_ops.py``) on both devices: on
CUDA tensors its kernel in ``csrc/torch_ops.cpp`` launches this one with
the plan, on CPU tensors its CPU kernel is the plain version.
``l2_normalize_pair`` (the normalisation alone, into two fp32 maps) serves
kernel E's normalised form.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from esmstereo_tpu_torch.ops.cost_volume import (build_gwc_volume,
                                                 build_gwc_volume_norm,
                                                 build_norm_correlation_volume,
                                                 l2_normalize_groups)
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             refuse_autograd, stream_handle,
                                             torch_ops)

_P = ctypes.c_void_p
_I = ctypes.c_int
# (C, G) instances of the CUDA kernel
KERNEL_FORMS = ((64, 32), (64, 1))
SMS = 132             # an H100's SMs
# (columns, thread rows) a block, a thread a column: the kernel's instances,
# the same list as csrc/correlation.cu's CORR_BLOCKS
BLOCKS = ((64, 4), (32, 8), (32, 4))
SMEM_MAX = 232448     # dynamic shared memory a block may use (227 KB)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def corr_smem(c: int, g: int, normalize: bool, columns: int,
              d: int) -> int:
    """Bytes of shared memory of a block: the fp32 target window of all
    ``c`` channels, the ``columns`` + ``d`` - 1 columns its ``d`` shifts
    reach from its ``columns``; normalised, also its ``columns`` reference
    columns, and each column's ``g`` group norms."""
    span = columns + d - 1
    if normalize:
        return 4 * (c + g) * (span + columns)
    return 4 * c * span


@dataclasses.dataclass(frozen=True)
class CorrPlan:
    """How one call launches: ``columns`` x ``rows`` threads a block, a
    thread a column, the block's ``rows`` splitting the D shifts; ``smem``
    bytes of dynamic shared memory; ``grid`` (column tiles, H, B)."""

    columns: int
    rows: int
    smem: int
    grid: tuple

    def ints(self) -> tuple:
        """The entry point's ``plan`` argument."""
        return (self.columns, self.rows, self.smem)


def column_tiles(w: int, columns: int, esize: int) -> int:
    """Column tiles a row: one more where a row of the volume (``esize``
    bytes a value) is not a whole number of 32-byte sectors, whose tiles
    the kernel shifts to start on sector boundaries (``row_skew``)."""
    return _cdiv(w, columns) + (w % (32 // esize) != 0)


def make_plan(b: int, c: int, g: int, h: int, w: int, d: int,
              normalize: bool, columns: int, rows: int,
              esize: int = 4) -> CorrPlan:
    """The plan of ``columns`` x ``rows`` blocks for a call of these
    shapes and form, on values of ``esize`` bytes."""
    return CorrPlan(columns, rows, corr_smem(c, g, normalize, columns, d),
                    (column_tiles(w, columns, esize), h, b))


@functools.lru_cache(maxsize=None)
def corr_plan(b: int, c: int, g: int, h: int, w: int, d: int,
              normalize: bool, esize: int = 4) -> CorrPlan:
    """The plan of one call, on values of ``esize`` bytes, picked by device
    time on the H100 (``eval/conv_repeat.py --bf-plans``): 32 x 8 blocks
    for the normalised forms; for gwc, 64 x 4 in fp32 where those give
    three blocks an SM (L), else 32 x 8 where 32 x 4 would not give every
    SM a block (S), else 32 x 4. Raises ``NotImplementedError`` for a form
    the kernel does not take, or a D whose window does not fit a block's
    shared memory. Cached: a call costs the host a lookup."""
    check_kernel_form("correlation_volume", c, g)
    if g == 1 and not normalize:
        raise NotImplementedError("correlation_volume kernel takes G = 1 "
                                  "normalised only (norm-correlation)")
    if normalize:
        block = (32, 8)
    elif esize == 4 and b * h * column_tiles(w, 64, esize) >= 3 * SMS:
        block = (64, 4)
    elif b * h * column_tiles(w, 32, esize) < SMS:
        block = (32, 8)
    else:
        block = (32, 4)
    plan = make_plan(b, c, g, h, w, d, normalize, *block, esize)
    if plan.smem > SMEM_MAX:
        raise NotImplementedError(
            f"correlation_volume kernel: D={d} needs {plan.smem} bytes of "
            f"shared memory a block, above {SMEM_MAX}")
    return plan


def volume_form(dtype: torch.dtype, normalize: bool,
                round_products: bool = True) -> str:
    """The form of a volume on ``dtype`` descriptors: ``"fp32"``; or in
    bf16 ``"bf16"`` / ``"bf16_norm"`` (B's rounding, gwc or normalised)
    and ``"bf16_d"`` / ``"bf16_d_norm"`` (D's). ``round_products`` picks
    B's (True) or D's (False) rounding and says nothing in fp32."""
    if dtype == torch.float32:
        return "fp32"
    if dtype != torch.bfloat16:
        raise TypeError(f"correlation_volume: takes fp32 or bf16, got {dtype}")
    return ("bf16" if round_products else "bf16_d") + (
        "_norm" if normalize else "")


def bf16_volume_plain(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                      num_groups: int, normalize: bool,
                      round_products: bool) -> torch.Tensor:
    """Plain version of the bf16 forms: (B, C, H, W) bf16 x 2 -> (B, G, D,
    H, W) bf16. The descriptors in fp32 (normalised there), the fp32
    products rounded to bf16 first with ``round_products`` (B) or not (D),
    the group's sum in fp32 times 1/(C/G), one rounding to bf16."""
    b, c, h, w = ref.shape
    cpg = c // num_groups
    r, t = ref.float(), tgt.float()
    if normalize:
        r, t = (l2_normalize_groups(r, num_groups),
                l2_normalize_groups(t, num_groups))
    padded = torch.nn.functional.pad(t, (max_disp - 1, 0))
    off = max_disp - 1
    planes = []
    for d in range(max_disp):
        prod = r * padded[..., off - d:off - d + w]
        if round_products:
            prod = prod.to(torch.bfloat16).float()
        s = prod.view(b, num_groups, cpg, h, w).sum(dim=2)
        planes.append((s * (1.0 / cpg)).to(torch.bfloat16))
    return torch.stack(planes, dim=2)


def correlation_volume_plain(ref: torch.Tensor, tgt: torch.Tensor,
                             max_disp: int, num_groups: int,
                             normalize: bool = False,
                             round_products: bool = True) -> torch.Tensor:
    """Plain PyTorch version of each form (``volume_form``): on bf16
    descriptors ``bf16_volume_plain`` in B's or D's rounding, normalised or
    not; otherwise the ``ops.cost_volume`` builder of the form, in the
    descriptors' dtype."""
    if ref.dtype == torch.bfloat16:
        return bf16_volume_plain(ref, tgt, max_disp, num_groups, normalize,
                                 round_products)
    if not normalize:
        return build_gwc_volume(ref, tgt, max_disp, num_groups)
    if num_groups == 1:
        return build_norm_correlation_volume(ref, tgt, max_disp)
    return build_gwc_volume_norm(ref, tgt, max_disp, num_groups)


def _op_plain(ref, tgt, max_disp, num_groups, normalize, round_products,
              plan):
    """``esmstereo::correlation_volume``'s CPU kernel: the plain
    version."""
    return correlation_volume_plain(ref, tgt, max_disp, num_groups,
                                    normalize, round_products)


def _op_fake(ref, tgt, max_disp, num_groups, normalize, round_products,
             plan):
    b, _, h, w = ref.shape
    return ref.new_empty((b, num_groups, max_disp, h, w))


torch_ops.register("correlation_volume", _op_plain, _op_fake)


@functools.cache
def _normalize_fn():
    fn = _build.load("correlation").l2_normalize_groups
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def check_kernel_form(what: str, c: int, num_groups: int) -> None:
    if (c, num_groups) not in KERNEL_FORMS:
        raise NotImplementedError(
            f"{what} kernel takes (C, G) in {KERNEL_FORMS}; got "
            f"({c}, {num_groups})")


def l2_normalize_pair(ref: torch.Tensor, tgt: torch.Tensor, num_groups: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both CUDA maps (fp32 or bf16) scaled to ``x / (||x_g|| + 1e-5)`` per
    pixel and group, in fp32, into new tensors, in one launch of
    ``l2_normalize_groups``: the first step of kernel E on its normalised
    form (kernels B and D normalise inside their one launch). The bf16
    forms keep the normalised maps in fp32, as the Pallas kernels do."""
    refuse_autograd("l2_normalize_pair", ref, tgt)
    b, c, h, w = ref.shape
    out_r = torch.empty(ref.shape, device=ref.device, dtype=torch.float32)
    out_t = torch.empty_like(out_r)
    err = _normalize_fn()(ref.data_ptr(), tgt.data_ptr(), out_r.data_ptr(),
                          out_t.data_ptr(), b, c, num_groups, h, w,
                          int(ref.dtype == torch.bfloat16),
                          stream_handle(ref))
    _build.check(err, "l2_normalize_groups")
    count_launch(l2_normalize_pair,
                 "bf16" if ref.dtype == torch.bfloat16 else "fp32")
    return out_r, out_t


l2_normalize_pair.launches = 0
l2_normalize_pair.form_launches = {}


def correlation_volume(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                       num_groups: int, normalize: bool = False,
                       round_products: bool = True) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, G, D, H, W) in the descriptors' dtype: the
    kernel on CUDA tensors, the plain version on CPU tensors. The kernel
    takes C=64 with G=32 (gwc, gwc_norm) or G=1 normalised
    (norm-correlation), in fp32 or bf16; in bf16 ``round_products`` picks
    B's rounding (True, the model's) or D's (False)."""
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
        return torch_ops.op("correlation_volume")(
            ref, tgt, max_disp, num_groups, normalize, round_products, [])
    return volume_kernel(ref, tgt, max_disp, num_groups, normalize,
                         round_products,
                         corr_plan(b, c, num_groups, h, w, max_disp,
                                   normalize, ref.element_size()))


def volume_kernel(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                  num_groups: int, normalize: bool, round_products: bool,
                  plan: CorrPlan) -> torch.Tensor:
    """The kernel's launch on CUDA tensors under ``plan``, through
    ``esmstereo::correlation_volume``, counted as a launch of
    ``correlation_volume``, which passes ``corr_plan``'s plan; the ragged
    checks of ``chip_smoke.py`` and ``eval/conv_repeat.py --bf-plans``
    pass the other blocks' (``make_plan``). The entry point refuses a plan
    that does not fit the shapes."""
    if not on_cuda("correlation_volume", ref, tgt,
                   dtypes=(torch.float32, torch.bfloat16)):
        raise ValueError("volume_kernel: takes CUDA tensors")
    torch_ops.load_cuda()
    out = torch_ops.op("correlation_volume")(
        ref, tgt, max_disp, num_groups, normalize, round_products,
        list(plan.ints()))
    count_launch(correlation_volume,
                 volume_form(ref.dtype, normalize, round_products))
    return out


correlation_volume.launches = 0
correlation_volume.form_launches = {}
