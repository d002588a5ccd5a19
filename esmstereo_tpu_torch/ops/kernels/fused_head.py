"""Kernel A: backbone stem + stage 0 of efficientnet_b2 (``csrc/fused_head.cu``).

Replaces ``esmstereo_tpu/ops/pallas/fused_head.py::fused_stage0_apply``.
``consts`` holds the BN-folded weights that ``backbones.fused.prepare_consts``
takes from a ``FeaturePyramid``:

  * ``stem_w`` (C0, 3, 3, 3), ``stem_b`` (C0,)  -- conv_stem + bn1, ReLU6;
  * ``blocks``: one dict per stage-0 depthwise-separable block with
    ``dw_w`` (C, 3, 3), ``dw_b`` (C,), ``se_w1`` (R, C), ``se_b1`` (R,),
    ``se_w2`` (C, R), ``se_b2`` (C,), ``pw_w`` (O, C), ``pw_b`` (O,) and
    ``residual``;
  * ``packed``: all of the above flattened by ``pack_params``, which is what
    the kernel reads.

The kernel takes the efficientnet_b2 layout (32 -> 16 -> 16, two SE
blocks, SiLU). mobilenetv2's one block without SE is not in this slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.ops.kernels import _build, on_cuda, stream_handle

_P = ctypes.c_void_p
_I = ctypes.c_int

_BLOCK_KEYS = ("dw_w", "dw_b", "se_w1", "se_b1", "se_w2", "se_b2", "pw_w",
               "pw_b")
# (C, R, O, residual) of the two b2 blocks the kernel is written for
_B2_LAYOUT = ((32, 8, 16, False), (16, 4, 16, True))


def stage0_plain(img: torch.Tensor, consts: dict) -> torch.Tensor:
    """Plain PyTorch version: (B, 3, H, W) -> (B, O, H/2, W/2)."""
    x = torch.clamp(F.conv2d(img, consts["stem_w"], consts["stem_b"],
                             stride=2, padding=1), 0.0, 6.0)
    for blk in consts["blocks"]:
        c = blk["dw_w"].shape[0]
        a = F.silu(F.conv2d(x, blk["dw_w"].unsqueeze(1), blk["dw_b"],
                            padding=1, groups=c))
        m = a.mean(dim=(2, 3))
        g = torch.sigmoid(F.linear(F.silu(F.linear(m, blk["se_w1"],
                                                   blk["se_b1"])),
                                   blk["se_w2"], blk["se_b2"]))
        y = F.conv2d(a * g[:, :, None, None], blk["pw_w"][:, :, None, None],
                     blk["pw_b"])
        x = y + x if blk["residual"] else y
    return x


def _check_layout(consts: dict) -> None:
    blocks = consts["blocks"]
    layout = tuple((b["dw_w"].shape[0], b["se_w1"].shape[0],
                    b["pw_w"].shape[0], bool(b["residual"])) for b in blocks)
    if tuple(consts["stem_w"].shape) != (32, 3, 3, 3) or layout != _B2_LAYOUT:
        raise NotImplementedError(
            f"fused_stage0 kernel takes the efficientnet_b2 stage 0 "
            f"{_B2_LAYOUT}; got {layout}")


def pack_params(consts: dict) -> torch.Tensor:
    """Flatten ``consts`` in the kernel's packed order (``csrc/fused_head.cu``)."""
    parts = [consts["stem_w"], consts["stem_b"]]
    for blk in consts["blocks"]:
        parts += [blk[k] for k in _BLOCK_KEYS]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


@functools.cache
def _lib():
    lib = _build.load("fused_head")
    lib.fused_stage0.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.fused_stage0.restype = _I
    lib.stage0_params_size.argtypes = []
    lib.stage0_params_size.restype = _I
    lib.stage0_workspace_floats.argtypes = [_I, _I, _I]
    lib.stage0_workspace_floats.restype = ctypes.c_longlong
    return lib


def fused_stage0(img: torch.Tensor, consts: dict) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 16, H/2, W/2): the kernel on CUDA tensors, the
    plain version on CPU tensors. H and W must be even."""
    if img.ndim != 4 or img.shape[1] != 3 or img.shape[2] % 2 or \
            img.shape[3] % 2:
        raise ValueError(f"fused_stage0: image {tuple(img.shape)}")
    tensors = [consts["stem_w"], consts["stem_b"], consts["packed"]] + [
        b[k] for b in consts["blocks"] for k in _BLOCK_KEYS]
    if not on_cuda("fused_stage0", img, *tensors):
        return stage0_plain(img, consts)
    _check_layout(consts)
    lib = _lib()
    params = consts["packed"]
    if params.numel() != lib.stage0_params_size():
        raise ValueError("fused_stage0: packed parameter size mismatch")
    b, _, h, w = img.shape
    ws = torch.empty(lib.stage0_workspace_floats(b, h, w), device=img.device,
                     dtype=torch.float32)
    out = torch.empty((b, 16, h // 2, w // 2), device=img.device,
                      dtype=torch.float32)
    err = lib.fused_stage0(img.data_ptr(), params.data_ptr(), out.data_ptr(),
                           ws.data_ptr(), b, h, w, stream_handle(img))
    _build.check(err, "fused_stage0")
    fused_stage0.launches += 1
    return out


fused_stage0.launches = 0
