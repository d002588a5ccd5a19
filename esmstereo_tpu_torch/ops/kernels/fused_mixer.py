"""Kernel I: the ShuffleMixer section of the cv4 upsampler's stage2x
(``csrc/fused_mixer.cu``).

Replaces ``esmstereo_tpu/attic/fused_mixer.py::fused_mixer_apply``:
to_feat (3x3, 32 -> 16, no bias) -> FMBlock x2 -> the 1x1 up conv + SiLU
with the x2 pixel shuffle, on the 16-channel map at /4. The JAX kernel
stores the phase-major pre-shuffle map for its phase-space tail; the port's
tail is a plain conv, so the kernel returns the shuffled ``(B, 16, 2H, 2W)``
map, the same tensor as ``stage.up(stage.block1(stage.block0(
stage.to_feat(x))))``.

``prepare_consts`` packs the weights of ``to_feat``, ``block0``,
``block1`` and ``up`` into one flat tensor in the kernel's order
(``LAYOUT``, mirrored by the offsets in the source), as
``prepare_consts`` there (``:84``) does for its lanes; its flat-lane banded
matrices are not ported. The plain version reads the packed tensor through
the same layout, so the CPU tests exercise the packing.

The bf16 form (a bf16 input, with ``prepare_consts(...,
low_precision=True)``) rounds where the TPU kernel's bf16 matmul operands
round (``fused_mixer.py:198-209`` there, whatever the model's dtype): the
conv and linear weights in the packed tensor, and each such layer's input,
to bf16 (``ROUNDINGS`` names the inputs' steps); the LayerNorm statistics
(``_mm(..., False)`` there), sums, biases and the residual stream stay
fp32, and the output is bf16, as ``phased_upsample.py:497`` casts it.

On CUDA a call is one cooperative launch of seven phases with grid
barriers between them (``csrc/fused_mixer.cu`` says where the section is
split), laid out by ``mixer_plan``; it counts as one launch, by form in
``form_launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.shufflemixer import channel_shuffle
from esmstereo_tpu_torch.ops.kernels import (_build, count_launch, on_cuda,
                                             stream_handle)
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import SMEM_MAX, SMS
from esmstereo_tpu_torch.ops.sampling import pixel_shuffle

_P = ctypes.c_void_p
_I = ctypes.c_int
_C = 16          # mixer width
_CIN = 32        # spx output channels
_LN_EPS = 1e-5


def _mlp_layout(prefix: str) -> list:
    """A pre-norm and its split-point MLP."""
    return [(prefix + "norm", (_C,)), (prefix + "fc1_w", (_C, _C // 2)),
            (prefix + "fc1_b", (_C,)), (prefix + "fc2_w", (_C // 2, _C)),
            (prefix + "fc2_b", (_C // 2,))]


def _layout() -> tuple:
    out = [("to_feat", (_CIN, 9, _C))]
    for b in ("block0", "block1"):
        for s in ("sm1", "sm2"):
            p = f"{b}.{s}."
            out += (_mlp_layout(p + "1.") + [(p + "dw_w", (_C, 49)),
                                             (p + "dw_b", (_C,))]
                    + _mlp_layout(p + "2."))
        out += [(b + ".expand_w", (_C, 9, 2 * _C)), (b + ".expand_b", (2 * _C,)),
                (b + ".project_w", (_C, 2 * _C)), (b + ".project_b", (_C,))]
    return tuple(out + [("up_w", (4 * _C, _C)), ("up_b", (4 * _C,))])


LAYOUT = _layout()
PARAMS_SIZE = sum(int(torch.Size(s).numel()) for _, s in LAYOUT)
# the packed entries that are matmul operands (rounded to bf16 in the bf16
# form); the norms and biases stay fp32
_WEIGHTS = ("to_feat", "fc1_w", "fc2_w", "dw_w", "expand_w", "project_w",
            "up_w")


def unpack(packed: torch.Tensor) -> dict:
    """``{name: view}`` of a packed parameter tensor, as ``LAYOUT`` lays it
    out."""
    if packed.shape != (PARAMS_SIZE,):
        raise ValueError(f"mixer: packed parameters {tuple(packed.shape)}, "
                         f"the 16-wide section has ({PARAMS_SIZE},)")
    views, at = {}, 0
    for name, shape in LAYOUT:
        n = int(torch.Size(shape).numel())
        views[name] = packed[at:at + n].view(shape)
        at += n
    return views


def _taps_last(w: torch.Tensor) -> torch.Tensor:
    """Conv weight (O, I, 3, 3) -> (I, 9, O), output channel fastest."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], 9, w.shape[0])


def prepare_consts(stage, low_precision: bool = False) -> dict:
    """The packed weights of a mixer stage (the port's ``_UpStage`` with
    ``use_mixer``): ``{"packed": (PARAMS_SIZE,) fp32 tensor}``; with
    ``low_precision`` (the bf16 form's) the conv and linear weights in it
    are rounded to bf16."""
    vals = {"to_feat": _taps_last(stage.to_feat.weight)}
    for b in ("block0", "block1"):
        blk = getattr(stage, b)
        for s in ("sm1", "sm2"):
            sm = getattr(blk, s)
            p = f"{b}.{s}."
            for i, norm, mlp in ((1, sm.norm1, sm.mlp1), (2, sm.norm2, sm.mlp2)):
                q = f"{p}{i}."
                vals.update({q + "norm": norm.weight,
                             q + "fc1_w": mlp.fc1.weight[:, :, 0, 0],
                             q + "fc1_b": mlp.fc1.bias,
                             q + "fc2_w": mlp.fc2.weight[:, :, 0, 0],
                             q + "fc2_b": mlp.fc2.bias})
            vals[p + "dw_w"] = sm.spatial.weight.reshape(_C, 49)
            vals[p + "dw_b"] = sm.spatial.bias
        vals[b + ".expand_w"] = _taps_last(blk.conv_expand.weight)
        vals[b + ".expand_b"] = blk.conv_expand.bias
        vals[b + ".project_w"] = blk.conv_project.weight[:, :, 0, 0]
        vals[b + ".project_b"] = blk.conv_project.bias
    vals["up_w"] = stage.up.conv.weight[:, :, 0, 0]
    vals["up_b"] = stage.up.conv.bias
    for name, shape in LAYOUT:
        if tuple(vals[name].shape) != shape:
            raise ValueError(f"mixer: {name} {tuple(vals[name].shape)}, the "
                             f"16-wide section has {shape}")
    if low_precision:
        vals = {n: v.to(torch.bfloat16).float()
                if n.split(".")[-1] in _WEIGHTS else v
                for n, v in vals.items()}
    packed = torch.cat([vals[n].reshape(-1) for n, _ in LAYOUT]).contiguous()
    return {"packed": packed}


# the bf16 form's rounding steps, by the operand each rounds (the
# LayerNorm output splits into fc1's half and the half that passes through
# to the residual stream)
ROUNDINGS = ("fc1", "pass_through", "fc2", "dw", "expand", "project", "up")


# the kernel's seven phases (csrc/fused_mixer.cu): the tensors each reads
# (x, or a name and the phase that wrote it) and writes, by name
STEPS = ((("x",), ("v", "t")),
         ((("t", 1),), ("u",)),
         ((("u", 2), ("v", 1)), ("x2",)),
         ((("x2", 3),), ("v", "u")),
         ((("u", 4),), ("t",)),
         ((("t", 5), ("v", 4)), ("x2",)),
         ((("x2", 6),), ("y",)))


def mixer_step_plain(step: int, consts: dict, low: bool,
                     exact: tuple = (), **inputs) -> dict:
    """Plain version of the kernel's phase ``step`` (1-7, ``STEPS``) on
    the tensors it reads (fp32, ``x`` in its own dtype): ``{name: fp32
    tensor}`` of what it writes, the last phase's ``y`` in bf16 with
    ``low``. ``low`` is the bf16 form (each conv's and linear layer's input
    rounded to bf16); ``exact`` as in ``mixer_plain``."""
    p = unpack(consts["packed"])

    def operand(t, step_):
        return t.to(torch.bfloat16).float() if low and step_ not in exact \
            else t

    def conv(v, step_, w, b=None, groups=1):
        return F.conv2d(operand(v, step_), w, b, padding=w.shape[-1] // 2,
                        groups=groups)

    def mlp_residual(v, pre):
        mu = v.mean(dim=1, keepdim=True)
        var = v.var(dim=1, keepdim=True, unbiased=False)
        n = ((v - mu) / torch.sqrt(var + _LN_EPS)
             * p[pre + "norm"].view(1, -1, 1, 1))
        h = F.silu(conv(n[:, :_C // 2], "fc1",
                        p[pre + "fc1_w"][..., None, None], p[pre + "fc1_b"]))
        y1 = conv(h, "fc2", p[pre + "fc2_w"][..., None, None],
                  p[pre + "fc2_b"])
        rest = operand(n[:, _C // 2:], "pass_through")
        return v + channel_shuffle(torch.cat([y1, rest], dim=1), 8)

    def taps(w):            # (I, 9, O) -> (O, I, 3, 3)
        return w.permute(2, 0, 1).reshape(w.shape[2], w.shape[0], 3, 3)

    def dw_half(y, pre):    # an SMLayer's dw 7x7 and its post-norm MLP
        y = conv(y, "dw", p[pre + "dw_w"].view(_C, 1, 7, 7),
                 p[pre + "dw_b"], groups=_C)
        return mlp_residual(y, pre + "2.")

    def expand(x2, b):      # an FMBlock's bottleneck and its residual
        z = F.silu(conv(x2, "expand", taps(p[b + ".expand_w"]),
                        p[b + ".expand_b"]))
        return conv(z, "project", p[b + ".project_w"][..., None, None],
                    p[b + ".project_b"]) + x2

    blk = "block0" if step <= 3 else "block1"
    if step == 1:
        v = conv(inputs["x"].to(p["to_feat"].dtype), "to_feat",
                 taps(p["to_feat"]))
        return {"v": v, "t": mlp_residual(v, "block0.sm1.1.")}
    if step in (2, 5):
        return {"u" if step == 2 else "t": mlp_residual(
            dw_half(inputs["t" if step == 2 else "u"], f"{blk}.sm1."),
            f"{blk}.sm2.1.")}
    if step in (3, 6):
        return {"x2": dw_half(inputs["u" if step == 3 else "t"],
                              f"{blk}.sm2.") + inputs["v"]}
    if step == 4:
        v = expand(inputs["x2"], "block0")
        return {"v": v, "u": mlp_residual(v, "block1.sm1.1.")}
    if step == 7:
        y = conv(expand(inputs["x2"], "block1"), "up",
                 p["up_w"][..., None, None], p["up_b"])
        y = F.silu(pixel_shuffle(y, 2))
        return {"y": y.to(torch.bfloat16) if low else y}
    raise ValueError(f"mixer: no phase {step}")


def mixer_plain(x: torch.Tensor, consts: dict,
                exact: tuple = ()) -> torch.Tensor:
    """Plain PyTorch version: (B, 32, H, W) -> (B, 16, 2H, 2W); in the bf16
    form each conv's and linear layer's input rounded to bf16, the rest in
    fp32, and the output in bf16: the kernel's seven phases
    (``mixer_step_plain``) one after the other. The steps of ``ROUNDINGS``
    named in ``exact`` keep their operand in fp32 (a check that the
    comparison sees each rounding)."""
    return _steps_plain(x, consts, exact)[-1]["y"]


def _steps_plain(x: torch.Tensor, consts: dict, exact: tuple = ()) -> list:
    low = x.dtype == torch.bfloat16
    outs = []
    for step, (reads, _) in enumerate(STEPS, 1):
        args = {"x": x} if step == 1 else {
            name: outs[k - 1][name] for name, k in reads}
        outs.append(mixer_step_plain(step, consts, low, exact, **args))
    return outs


# The launch layout (``csrc/fused_mixer.cu`` has the same constants):
# tiles of 3 x 32 pixels, 192 threads (two a pixel), at most
# ``MIXER_BLOCKS_PER_SM`` blocks an SM (its ``__launch_bounds__``); shared
# memory: the largest phase's staged weights (an expand phase's: expand,
# project and up with their biases), then the data area (a slab and the
# expand's SiLU map, then the residual stream at ``_VS``).
MIXER_TILE = (3, 32)
MIXER_THREADS = 192
MIXER_BLOCKS_PER_SM = 3
_W_MAX = _C * 9 * 2 * _C + 2 * _C + 2 * _C * _C + _C + 4 * _C * _C + 4 * _C
_VS = 6144


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MixerPlan:
    """How ``mixer`` launches (``csrc/fused_mixer.cu``): ``tile`` (rows,
    columns of pixels), one cooperative ``grid`` of ``threads`` a block
    (all blocks resident), ``smem`` dynamic shared bytes a block and
    ``workspace`` floats (V, T, U and the barrier counter)."""

    tile: tuple
    grid: int
    threads: int
    smem: int
    workspace: int


@functools.lru_cache(maxsize=None)
def mixer_plan(batch: int, h: int, w: int) -> MixerPlan:
    """The launch plan of kernel I on a (batch, 32, h, w) spx map: at most
    ``MIXER_BLOCKS_PER_SM`` blocks an SM, no more than the tiles. Raises
    ``ValueError`` for an empty map."""
    if min(batch, h, w) < 1:
        raise ValueError(f"mixer_plan: map ({batch}, {_CIN}, {h}, {w})")
    th, tw = MIXER_TILE
    tiles = batch * _cdiv(h, th) * _cdiv(w, tw)
    smem = 4 * (_W_MAX + _VS + _C * th * tw)
    if smem > SMEM_MAX:
        raise ValueError(f"mixer_plan: {smem} bytes of shared memory")
    return MixerPlan(MIXER_TILE, min(tiles, SMS * MIXER_BLOCKS_PER_SM),
                     MIXER_THREADS, smem, 3 * batch * _C * h * w + 4)


# csrc/fused_mixer.cu's fused_mixer(x, params, y, ws, B, H, W,
# low_precision, stop, grid, threads, smem, ws_floats, stream)
MIXER_ARGTYPES = [_P, _P, _P, _P] + [_I] * 8 + [ctypes.c_longlong, _P]


@functools.cache
def _lib():
    lib = _build.load("fused_mixer")
    lib.fused_mixer.argtypes = MIXER_ARGTYPES
    lib.fused_mixer.restype = _I
    lib.mixer_params_size.argtypes = []
    lib.mixer_params_size.restype = _I
    return lib


def mixer(x: torch.Tensor, consts: dict, steps: bool = False):
    """(B, 32, H, W) -> (B, 16, 2H, 2W), fp32 or, in the bf16 form (a bf16
    ``x``, its consts from ``prepare_consts(..., low_precision=True)``),
    bf16: the kernel on CUDA tensors, the plain version on CPU tensors.
    The form follows ``x``'s dtype, as in the other wrappers. With
    ``steps`` (for a check; the model never asks) the list of what each of
    the kernel's seven phases writes (``STEPS``: ``{name: tensor}``, the
    workspace's in fp32): a launch that stops after each phase in turn,
    each phase on the kernel's own earlier ones."""
    if x.ndim != 4 or x.shape[1] != _CIN or x.shape[2] == 0 \
            or x.shape[3] == 0:
        raise ValueError(f"mixer: input {tuple(x.shape)}; the kernel takes "
                         f"(B, {_CIN}, H, W)")
    form = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    packed = consts["packed"]
    if not on_cuda("mixer", x, packed,
                   dtypes=(torch.float32, torch.bfloat16)):
        # unpack raises on another width
        return _steps_plain(x, consts) if steps else mixer_plain(x, consts)
    lib = _lib()
    if packed.shape != (lib.mixer_params_size(),):
        raise ValueError(f"mixer: packed parameters {tuple(packed.shape)}, "
                         f"the kernel takes ({lib.mixer_params_size()},)")
    if packed.dtype != torch.float32:
        raise TypeError(f"mixer: packed parameters {packed.dtype}")
    b, _, h, w = x.shape
    plan = mixer_plan(b, h, w)
    ws = torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
    out = torch.empty((b, _C, 2 * h, 2 * w), device=x.device, dtype=x.dtype)

    def run(stop):
        err = lib.fused_mixer(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                              ws.data_ptr(), b, h, w, int(form == "bf16"),
                              stop, plan.grid, plan.threads, plan.smem,
                              plan.workspace, stream_handle(x))
        _build.check(err, "mixer")

    if not steps:
        run(len(STEPS))
        count_launch(mixer, form)
        return out
    # the workspace's three maps (csrc/fused_mixer.cu: V, T, U), and where
    # each phase writes its outputs
    maps = dict(zip("VTU", ws[:3 * b * _C * h * w].view(3, b, _C, h, w)))
    where = ({"v": "V", "t": "T"}, {"u": "U"}, {"x2": "T"},
             {"v": "V", "u": "U"}, {"t": "T"}, {"x2": "U"}, {})
    outs = []
    for stop, names in enumerate(where, 1):
        run(stop)
        outs.append({n: maps[m].clone() for n, m in names.items()}
                    if names else {"y": out.clone()})
    count_launch(mixer, form)
    return outs


mixer.launches = 0
mixer.form_launches = {}
