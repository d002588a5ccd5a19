"""Kernel A: backbone stem + stage 0 (``csrc/fused_head.cu``), in the two
layouts of the JAX kernel.

Replaces ``esmstereo_tpu/ops/pallas/fused_head.py::fused_stage0_apply``.
``consts`` holds the BN-folded weights that ``backbones.fused.prepare_consts``
takes from a ``FeaturePyramid``:

  * ``stem_w`` (C0, 3, 3, 3), ``stem_b`` (C0,)  -- conv_stem + bn1, ReLU6;
  * ``blocks``: one dict per stage-0 depthwise-separable block with
    ``dw_w`` (C, 3, 3), ``dw_b`` (C,), ``pw_w`` (O, C), ``pw_b`` (O,),
    ``residual``, and with SqueezeExcite also ``se_w1`` (R, C), ``se_b1``
    (R,), ``se_w2`` (C, R), ``se_b2`` (C,);
  * ``act``: the blocks' activation (``"silu"`` or ``"relu6"``);
  * ``packed``: the weights flattened by ``pack_params`` in the form's
    order, which is what the kernel reads.

The kernel takes two forms (``FORMS``): efficientnet_b2's (32 -> 16 -> 16,
two blocks with SE, SiLU; one cooperative launch whose blocks meet at grid
barriers for the SE means) and mobilenetv2_100's (32 -> 16, one block
without SE or residual, ReLU6; one launch of a block a tile). Anything else
raises. Either writes fp32 or bf16 (``out_dtype``): inside it is fp32, and
the bf16 form rounds the output as the last phase stores it, as the JAX
model casts the kernel's output to its compute dtype
(``esmstereo_tpu/backbones/fused.py:174-175``). ``stage0_plan`` lays a call
out (tiles, grid, threads, shared memory, workspace); the C entry point
refuses any other layout.

The wrapper calls the operator ``esmstereo::fused_stage0``
(``torch_ops.py``) on the image and the packed weights: its CUDA kernel is
``csrc/torch_ops.cpp``'s, which launches this kernel; its CPU kernel
unpacks the weights by form (``unpack_params``) and runs the plain
version.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.ops.kernels import count_launch, on_cuda, torch_ops
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import SMEM_MAX, SMS

_DW_KEYS = ("dw_w", "dw_b")
_SE_KEYS = ("se_w1", "se_b1", "se_w2", "se_b2")
_PW_KEYS = ("pw_w", "pw_b")
# name -> (the C entry point's form number, the blocks' activation, and per
# block (C, R, O, residual), R = 0 for a block without SqueezeExcite)
FORMS = {"efficientnet_b2": (0, "silu", ((32, 8, 16, False),
                                         (16, 4, 16, True))),
         "mobilenetv2_100": (1, "relu6", ((32, 0, 16, False),))}
_ACTS = {"silu": F.silu, "relu6": lambda x: torch.clamp(x, 0.0, 6.0)}


def _block_keys(blk: dict) -> tuple[str, ...]:
    return _DW_KEYS + (_SE_KEYS if "se_w1" in blk else ()) + _PW_KEYS


def stage0_plain(img: torch.Tensor, consts: dict) -> torch.Tensor:
    """Plain PyTorch version: (B, 3, H, W) -> (B, O, H/2, W/2)."""
    act = _ACTS[consts["act"]]
    x = torch.clamp(F.conv2d(img, consts["stem_w"], consts["stem_b"],
                             stride=2, padding=1), 0.0, 6.0)
    for blk in consts["blocks"]:
        c = blk["dw_w"].shape[0]
        a = act(F.conv2d(x, blk["dw_w"].unsqueeze(1), blk["dw_b"],
                         padding=1, groups=c))
        if "se_w1" in blk:
            m = a.mean(dim=(2, 3))
            g = torch.sigmoid(F.linear(act(F.linear(m, blk["se_w1"],
                                                    blk["se_b1"])),
                                       blk["se_w2"], blk["se_b2"]))
            a = a * g[:, :, None, None]
        y = F.conv2d(a, blk["pw_w"][:, :, None, None], blk["pw_b"])
        x = y + x if blk["residual"] else y
    return x


def kernel_form(consts: dict) -> str:
    """The name of the form in ``FORMS`` that ``consts`` has; raises
    ``NotImplementedError`` for a layout the kernel does not take."""
    layout = tuple((b["dw_w"].shape[0],
                    b["se_w1"].shape[0] if "se_w1" in b else 0,
                    b["pw_w"].shape[0], bool(b["residual"]))
                   for b in consts["blocks"])
    for name, (_, act, blocks) in FORMS.items():
        if (tuple(consts["stem_w"].shape) == (32, 3, 3, 3)
                and consts["act"] == act and layout == blocks):
            return name
    raise NotImplementedError(
        f"fused_stage0 kernel takes the stage 0 of {sorted(FORMS)}; got "
        f"{layout} with {consts['act']}")


def pack_params(consts: dict) -> torch.Tensor:
    """Flatten ``consts`` in the kernel's packed order
    (``csrc/fused_head.cu``): the stem, then per block dw, [SE,] pw."""
    parts = [consts["stem_w"], consts["stem_b"]]
    for blk in consts["blocks"]:
        parts += [blk[k] for k in _block_keys(blk)]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def unpack_params(name: str, packed: torch.Tensor) -> dict:
    """``pack_params`` undone for the form ``name`` of ``FORMS``: the
    consts ``stage0_plain`` takes (views into ``packed``)."""
    _, act, layout = FORMS[name]
    shapes = [("stem_w", (32, 3, 3, 3)), ("stem_b", (32,))]
    for i, (c, r, o, _) in enumerate(layout):
        shapes += [((i, "dw_w"), (c, 3, 3)), ((i, "dw_b"), (c,))]
        if r:
            shapes += [((i, "se_w1"), (r, c)), ((i, "se_b1"), (r,)),
                       ((i, "se_w2"), (c, r)), ((i, "se_b2"), (c,))]
        shapes += [((i, "pw_w"), (o, c)), ((i, "pw_b"), (o,))]
    sizes = [torch.Size(shape).numel() for _, shape in shapes]
    if packed.numel() != sum(sizes):
        raise ValueError(f"fused_stage0: {packed.numel()} packed parameters, "
                         f"the {name} form has {sum(sizes)}")
    blocks = [{"residual": res} for *_, res in layout]
    consts = {"blocks": blocks, "act": act}
    for (key, shape), part in zip(shapes, packed.split(sizes)):
        if isinstance(key, tuple):
            blocks[key[0]][key[1]] = part.view(shape)
        else:
            consts[key] = part.view(shape)
    return consts


# The launch layout (``csrc/fused_head.cu`` has the same constants): tiles
# of 12 x 32 output pixels, 192 threads; the stem's and the pointwise
# convs' weights and biases in shared memory (``_WEIGHTS`` floats), the
# stem's 32 channels staged 8 at a time; at most ``STAGE0_BLOCKS_PER_SM``
# blocks an SM (the source's ``__launch_bounds__``), which sizes
# efficientnet_b2's cooperative grid.
STAGE0_TILE = (12, 32)
STAGE0_THREADS = 192
STAGE0_BLOCKS_PER_SM = 3
_CHUNK = 8
_WEIGHTS = 28 * 32 + 33 * 16 + 17 * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stage0_smem(form: str, batch: int) -> int:
    """Dynamic shared bytes a block: the staged weights, the image patch and
    8 stem channels on the tile's 1-pixel halo (y0 on that halo fits in the
    same space), then efficientnet_b2's SE gates of every image."""
    th, tw = STAGE0_TILE
    ny, nx = th + 2, tw + 2
    phase = 3 * (2 * ny + 1) * (2 * nx + 1) + _CHUNK * ny * nx
    gates = batch * (32 + 16) if form == "efficientnet_b2" else 0
    return 4 * (_WEIGHTS + phase + gates)


@dataclasses.dataclass(frozen=True)
class Stage0Plan:
    """How ``fused_stage0`` launches (``csrc/fused_head.cu``): ``tile``
    (rows, columns of output pixels), ``grid`` blocks of ``threads``
    (efficientnet_b2's a cooperative grid, all blocks resident; mobilenetv2's
    a block a tile), ``smem`` dynamic shared bytes a block, ``workspace``
    floats of scratch (a barrier counter, per-tile SE partials, y0, a0 and
    a1; none in mobilenetv2's form)."""

    form: str
    tile: tuple
    grid: int
    threads: int
    smem: int
    workspace: int


@functools.lru_cache(maxsize=None)
def stage0_plan(form: str, batch: int, hi: int, wi: int) -> Stage0Plan:
    """The launch plan of kernel A in ``form`` on a (batch, 3, hi, wi)
    image: mobilenetv2_100's a block a tile; efficientnet_b2's one
    cooperative grid of at most ``STAGE0_BLOCKS_PER_SM`` blocks an SM, no
    more than the tiles. Raises ``ValueError`` for another form, an odd or
    empty image, or shared memory above the card's."""
    if form not in FORMS:
        raise ValueError(f"stage0_plan: form {form!r}, not one of "
                         f"{sorted(FORMS)}")
    if batch < 1 or hi < 2 or wi < 2 or hi % 2 or wi % 2:
        raise ValueError(f"stage0_plan: image ({batch}, 3, {hi}, {wi})")
    th, tw = STAGE0_TILE
    h, w = hi // 2, wi // 2
    tiles = batch * _cdiv(h, th) * _cdiv(w, tw)
    if form == "mobilenetv2_100":
        grid, work = tiles, 0
    else:
        grid = min(tiles, SMS * STAGE0_BLOCKS_PER_SM)
        work = 4 + tiles * (32 + 16) + batch * (16 + 32 + 16) * h * w
    smem = stage0_smem(form, batch)
    if smem > SMEM_MAX:
        raise ValueError(f"stage0_plan: {smem} bytes of shared memory at "
                         f"batch {batch}, above {SMEM_MAX}")
    return Stage0Plan(form, STAGE0_TILE, grid, STAGE0_THREADS, smem, work)


def _op_plain(img, params, form, out_bf16, plan):
    """``esmstereo::fused_stage0``'s CPU kernel: the plain version, in the
    image's dtype or bf16."""
    name = next(n for n, f in FORMS.items() if f[0] == form)
    out = stage0_plain(img, unpack_params(name, params))
    return out.to(torch.bfloat16) if out_bf16 else out


def _op_fake(img, params, form, out_bf16, plan):
    b, _, h, w = img.shape
    return img.new_empty((b, 16, h // 2, w // 2),
                         dtype=torch.bfloat16 if out_bf16 else img.dtype)


torch_ops.register("fused_stage0", _op_plain, _op_fake)


_OUT_DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def fused_stage0(img: torch.Tensor, consts: dict,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 16, H/2, W/2) in ``out_dtype`` (the image's
    dtype by default; bf16 for the deploy form): the kernel on CUDA
    tensors (an fp32 image, fp32 or bf16 out) as ``stage0_plan`` lays it
    out, the plain version (then cast) on CPU tensors. H and W must be
    even."""
    if img.ndim != 4 or img.shape[1] != 3 or img.shape[2] % 2 or \
            img.shape[3] % 2:
        raise ValueError(f"fused_stage0: image {tuple(img.shape)}")
    out_dtype = out_dtype or img.dtype
    if out_dtype not in (img.dtype, torch.bfloat16):
        raise TypeError(f"fused_stage0: writes the image's dtype or bf16, "
                        f"not {out_dtype}")
    tensors = [consts["stem_w"], consts["stem_b"], consts["packed"]] + [
        b[k] for b in consts["blocks"] for k in _block_keys(b)]
    card = on_cuda("fused_stage0", img, *tensors)
    name = kernel_form(consts)
    plan = ()
    if card:
        b, _, h, w = img.shape
        p = stage0_plan(name, b, h, w)
        plan = (p.grid, p.threads, p.smem, p.workspace)
        torch_ops.load_cuda()
    out = torch_ops.op("fused_stage0")(img, consts["packed"], FORMS[name][0],
                                       out_dtype != img.dtype, list(plan))
    if card:
        count_launch(fused_stage0, _OUT_DTYPES[out_dtype])
    return out


fused_stage0.launches = 0
fused_stage0.form_launches = {}
