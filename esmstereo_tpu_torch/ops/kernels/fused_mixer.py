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

On CUDA a call makes seven launches (``csrc/fused_mixer.cu`` says where
the section is split); it counts as one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.shufflemixer import channel_shuffle
from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle
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


def prepare_consts(stage) -> dict:
    """The packed weights of a mixer stage (the port's ``_UpStage`` with
    ``use_mixer``): ``{"packed": (PARAMS_SIZE,) tensor}``."""
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
    packed = torch.cat([vals[n].reshape(-1) for n, _ in LAYOUT]).contiguous()
    return {"packed": packed}


def mixer_plain(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """Plain PyTorch version: (B, 32, H, W) -> (B, 16, 2H, 2W)."""
    p = unpack(consts["packed"])

    def conv(v, w, b=None, groups=1):
        return F.conv2d(v, w, b, padding=w.shape[-1] // 2, groups=groups)

    def mlp_residual(v, pre):
        mu = v.mean(dim=1, keepdim=True)
        var = v.var(dim=1, keepdim=True, unbiased=False)
        n = (v - mu) / torch.sqrt(var + _LN_EPS) * p[pre + "norm"].view(
            1, -1, 1, 1)
        h = F.silu(conv(n[:, :_C // 2], p[pre + "fc1_w"][..., None, None],
                        p[pre + "fc1_b"]))
        y1 = conv(h, p[pre + "fc2_w"][..., None, None], p[pre + "fc2_b"])
        return v + channel_shuffle(torch.cat([y1, n[:, _C // 2:]], dim=1), 8)

    def taps(w):            # (I, 9, O) -> (O, I, 3, 3)
        return w.permute(2, 0, 1).reshape(w.shape[2], w.shape[0], 3, 3)

    v = conv(x, taps(p["to_feat"]))
    for b in ("block0", "block1"):
        y = v
        for s in ("sm1", "sm2"):
            pre = f"{b}.{s}."
            y = mlp_residual(y, pre + "1.")
            y = conv(y, p[pre + "dw_w"].view(_C, 1, 7, 7), p[pre + "dw_b"],
                     groups=_C)
            y = mlp_residual(y, pre + "2.")
        x2 = y + v
        z = F.silu(conv(x2, taps(p[b + ".expand_w"]), p[b + ".expand_b"]))
        v = conv(z, p[b + ".project_w"][..., None, None],
                 p[b + ".project_b"]) + x2
    y = conv(v, p["up_w"][..., None, None], p["up_b"])
    return F.silu(pixel_shuffle(y, 2))


@functools.cache
def _lib():
    lib = _build.load("fused_mixer")
    lib.fused_mixer.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.fused_mixer.restype = _I
    lib.mixer_params_size.argtypes = []
    lib.mixer_params_size.restype = _I
    lib.mixer_workspace_floats.argtypes = [_I, _I, _I]
    lib.mixer_workspace_floats.restype = ctypes.c_longlong
    return lib


def mixer(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """(B, 32, H, W) -> (B, 16, 2H, 2W): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if x.ndim != 4 or x.shape[1] != _CIN or x.shape[2] == 0 \
            or x.shape[3] == 0:
        raise ValueError(f"mixer: input {tuple(x.shape)}; the kernel takes "
                         f"(B, {_CIN}, H, W)")
    packed = consts["packed"]
    if not on_cuda("mixer", x, packed):
        return mixer_plain(x, consts)      # unpack raises on another width
    lib = _lib()
    if packed.shape != (lib.mixer_params_size(),):
        raise ValueError(f"mixer: packed parameters {tuple(packed.shape)}, "
                         f"the kernel takes ({lib.mixer_params_size()},)")
    b, _, h, w = x.shape
    ws = torch.empty(lib.mixer_workspace_floats(b, h, w), device=x.device,
                     dtype=torch.float32)
    out = torch.empty((b, _C, 2 * h, 2 * w), device=x.device,
                      dtype=torch.float32)
    err = lib.fused_mixer(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                          ws.data_ptr(), b, h, w, stream_handle(x))
    _build.check(err, "mixer")
    mixer.launches += 1
    return out


mixer.launches = 0
