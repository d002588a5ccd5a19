"""Kernel J: one whole backbone stage >= 1 (``csrc/fused_stage.cu``).

Replaces ``esmstereo_tpu/attic/fused_stage.py::fused_stage_apply``.
``consts`` holds the BN-folded weights that
``backbones.fused_stage.prepare_stage_consts`` takes from a
``FeaturePyramid``'s stage: ``act`` (``"silu"`` or ``"relu6"``) and one dict
per block with

  * ``kind`` (``"ir"`` or ``"ds"``), ``k`` (3 or 5), ``stride`` (1, or 2 on
    the first block), ``cin``, ``mid`` (``6 cin`` for ``"ir"``, ``cin`` for
    ``"ds"``), ``cout``, ``residual``;
  * ``"ir"`` only: ``we`` (mid, cin), ``be`` (mid,) -- conv_pw + bn1 -- and
    ``we_t``, ``we`` transposed, which the kernel reads;
  * ``wd`` (mid, k, k), ``bd`` (mid,) -- conv_dw and its BN;
  * with SqueezeExcite: ``se_w1`` (R, mid), ``se_b1`` (R,), ``se_w2`` (mid,
    R), ``se_b2`` (mid,);
  * ``wp`` (cout, mid), ``bp`` (cout,) -- the project conv and its BN --
    and ``wp_t``, ``wp`` transposed.

The CUDA form runs each block as up to three launches (expand + depthwise,
the SE gate, project + residual), each wrapper call counting as one launch
(``form_launches["fp32"]``). It takes fp32 NCHW input at any size (even
at a stride-2 entry), the layouts above, and SE on every block or on none,
as the JAX kernel does (``:282``); anything else raises, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)

_P = ctypes.c_void_p
_I = ctypes.c_int
ACTS = {"silu": 0, "relu6": 1}     # the C entry point's act codes
_FNS = {"silu": F.silu, "relu6": lambda x: torch.clamp(x, 0.0, 6.0)}


def out_size(n: int, stride: int) -> int:
    """A block's output rows (or columns) from its input's: the depthwise
    conv pads k // 2, so stride 2 halves an even size."""
    return n // 2 if stride == 2 else n


def _shapes(blk: dict) -> dict:
    """The shape of each tensor the kernel reads of block ``blk``."""
    ci, m, co, k = blk["cin"], blk["mid"], blk["cout"], blk["k"]
    shapes = {"we_t": (ci, m), "be": (m,)} if blk["kind"] == "ir" else {}
    shapes.update({"wd": (m, k, k), "bd": (m,)})
    if "se_w1" in blk:
        r = blk["se_w1"].shape[0]
        shapes.update({"se_w1": (r, m), "se_b1": (r,), "se_w2": (m, r),
                       "se_b2": (m,)})
    shapes.update({"wp_t": (m, co), "bp": (co,)})
    return shapes


def block_tensors(blk: dict) -> list[torch.Tensor]:
    """The tensors the kernel reads of block ``blk``."""
    return [blk[k] for k in _shapes(blk)]


def unsupported(blocks, h: int, w: int) -> Exception | None:
    """The error for a stage the kernel does not take, or None: ``blocks``
    holds one ``(kind, k, stride, has_se)`` a block, on an ``h`` x ``w``
    input. The kernel takes blocks ``ds`` or ``ir`` with a k3 or k5
    depthwise conv, stride 2 only on the first block and then on an even
    input size, and SqueezeExcite on every block or on none (``:282``).
    The one statement of the rule: ``check_stage`` raises the error, and
    ``backbones.fused_stage.stage_supported`` answers whether there is
    one."""
    if not blocks:
        return NotImplementedError("fused_stage: a stage of no blocks")
    if len({se for *_, se in blocks}) != 1:
        return NotImplementedError("fused_stage: SqueezeExcite on some "
                                   "blocks and not others")
    for i, (kind, k, stride, _) in enumerate(blocks):
        if kind not in ("ir", "ds") or k not in (3, 5) or \
                stride not in (1, 2) or (stride == 2 and i > 0):
            return NotImplementedError(
                f"fused_stage: block {i} {kind} k{k} stride {stride}")
    if blocks[0][2] == 2 and (h % 2 or w % 2):
        return ValueError(f"fused_stage: odd input {h}x{w} at a stride-2 "
                          "entry")
    return None


def check_stage(consts: dict, shape) -> None:
    """Raise unless the kernel takes ``consts`` on an input of ``shape``
    (B, C, H, W): the rule of ``unsupported``, then the layouts above."""
    blocks = consts["blocks"]
    if consts["act"] not in ACTS:
        raise NotImplementedError(f"fused_stage: act {consts['act']!r}")
    if len(shape) != 4:
        raise ValueError(f"fused_stage: input {tuple(shape)}, want NCHW")
    err = unsupported([(b["kind"], b["k"], b["stride"], "se_w1" in b)
                       for b in blocks], shape[2], shape[3])
    if err is not None:
        raise err
    if shape[1] != blocks[0]["cin"]:
        raise ValueError(f"fused_stage: input {tuple(shape)} for a stage of "
                         f"{blocks[0]['cin']} channels in")
    h, w, c = shape[2], shape[3], shape[1]
    for i, b in enumerate(blocks):
        mid = c * 6 if b["kind"] == "ir" else c
        if b["cin"] != c or b["mid"] != mid or \
                b["residual"] != (b["stride"] == 1 and c == b["cout"]):
            raise ValueError(f"fused_stage: block {i} layout {b['cin']} -> "
                             f"{b['mid']} -> {b['cout']} after {c} channels")
        for key, want in _shapes(b).items():
            if tuple(b[key].shape) != want:
                raise ValueError(f"fused_stage: block {i} {key} "
                                 f"{tuple(b[key].shape)}, want {want}")
        h, w, c = out_size(h, b["stride"]), out_size(w, b["stride"]), \
            b["cout"]


def stage_reference(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """Plain PyTorch version: the BN-folded chain, block by block."""
    act = _FNS[consts["act"]]
    for blk in consts["blocks"]:
        e = x
        if blk["kind"] == "ir":
            e = act(F.conv2d(x, blk["we"][:, :, None, None], blk["be"]))
        d = act(F.conv2d(e, blk["wd"].unsqueeze(1), blk["bd"],
                         stride=blk["stride"], padding=blk["k"] // 2,
                         groups=blk["mid"]))
        if "se_w1" in blk:
            m = d.mean(dim=(2, 3))
            g = torch.sigmoid(F.linear(act(F.linear(m, blk["se_w1"],
                                                    blk["se_b1"])),
                                       blk["se_w2"], blk["se_b2"]))
            d = d * g[:, :, None, None]
        y = F.conv2d(d, blk["wp"][:, :, None, None], blk["bp"])
        x = y + x if blk["residual"] else y
    return x


@functools.cache
def _lib():
    lib = _build.load("fused_stage")
    lib.fused_stage_block.argtypes = [_P] * 14 + [_I] * 13 + [_P]
    lib.fused_stage_block.restype = _I
    lib.stage_workspace_floats.argtypes = [_I] * 4
    lib.stage_workspace_floats.restype = ctypes.c_longlong
    return lib


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fused_stage(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """(B, cin, H, W) -> (B, cout, H', W') through the stage's blocks: the
    kernel on CUDA tensors (fp32), the plain version on CPU tensors."""
    check_stage(consts, x.shape)
    tensors = [t for b in consts["blocks"] for t in block_tensors(b)]
    if not on_cuda("fused_stage", x, *tensors):
        return stage_reference(x, consts)
    lib = _lib()
    a = ACTS[consts["act"]]
    bsz, _, h, w = x.shape
    for blk in consts["blocks"]:
        s, mid, cout = blk["stride"], blk["mid"], blk["cout"]
        ho, wo = out_size(h, s), out_size(w, s)
        y = torch.empty((bsz, cout, ho, wo), device=x.device,
                        dtype=torch.float32)
        d = torch.empty((bsz, mid, ho, wo), device=x.device,
                        dtype=torch.float32)
        ws = torch.empty(lib.stage_workspace_floats(bsz, mid, ho, wo),
                         device=x.device, dtype=torch.float32)
        ir, se = blk["kind"] == "ir", "se_w1" in blk
        r = blk["se_w1"].shape[0] if se else 0
        err = lib.fused_stage_block(
            x.data_ptr(), y.data_ptr(), d.data_ptr(), ws.data_ptr(),
            _ptr(blk.get("we_t")), _ptr(blk.get("be")), blk["wd"].data_ptr(),
            blk["bd"].data_ptr(), _ptr(blk.get("se_w1")),
            _ptr(blk.get("se_b1")), _ptr(blk.get("se_w2")),
            _ptr(blk.get("se_b2")), blk["wp_t"].data_ptr(),
            blk["bp"].data_ptr(), bsz, blk["cin"], mid, cout, r, h, w,
            blk["k"], s, int(ir), int(se), int(blk["residual"]), a,
            stream_handle(x))
        _build.check(err, "fused_stage")
        x, h, w = y, ho, wo
    count_launch(fused_stage, "fp32")
    return x


fused_stage.launches = 0
fused_stage.form_launches = {}
