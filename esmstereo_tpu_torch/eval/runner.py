"""Eval-mode inference on a uint8 stereo pair.

Counterpart of ``esmstereo_tpu/eval/runner.py``: normalise, pad each image
top-left up to the NEXT multiple of 32 (zero fill, as the reference's PIL
crop with negative offsets), run the model, cut the padding off. A
confidence model's two maps are cropped alike.

The runner owns its precision: every forward runs with TF32 off for cuDNN
and matmuls (``fp32_precision``), so an fp32 model is the fp32 model the
tests hold against JAX whatever the process's flags, and a bf16 model's
fp32 steps (the regression and the disparity stream) are fp32 too. The
caller's flags are restored after each call. Inputs stay fp32 (each model
casts them where the JAX model does); the maps come back fp32 (a bf16
model's confidence map, bf16 on the device, is widened after its copy).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from esmstereo_tpu_torch.data.io import normalize_image


def pad_to_next_multiple(img: np.ndarray, m: int = 32) -> np.ndarray:
    """Zero-pad top/left so H and W become the NEXT multiple of ``m``
    (always grows, matching ``(w // m + 1) * m``)."""
    h, w = img.shape[:2]
    hi, wi = (h // m + 1) * m, (w // m + 1) * m
    pad = [(hi - h, 0), (wi - w, 0)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for cuDNN convolutions and CUDA matmuls while open; the
    flags as they were afterwards, also when the body raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def precision(model: torch.nn.Module) -> str:
    """The numerics ``model`` runs at under ``InferenceRunner``, in words:
    its compute dtype, the GELU form and TF32 off."""
    from esmstereo_tpu_torch.nn import blocks
    cfg = getattr(model, "config", None)
    dtype = getattr(cfg, "dtype", "float32")
    gelu = "tanh" if blocks.GELU_APPROXIMATE else "exact (erf)"
    int8 = ", int8 volume" if getattr(model, "volume_int8", False) else ""
    return f"{dtype} compute{int8}, {gelu} GELU, TF32 off"


class InferenceRunner:
    """uint8 HWC pair -> disparity map (and, for
    ``models.confidence.ESMStereoConfidence``, the confidence map), on the
    model's device."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.model = model.eval()
        self.device = next(model.parameters()).device

    def __call__(self, left_u8: np.ndarray, right_u8: np.ndarray):
        """Return (disparity H x W float32, wall seconds); for a confidence
        model ((disparity, confidence), wall seconds), both H x W float32.
        The time covers the host-to-device copy, the forward pass and the
        copies back, and ends after the device has finished (a copy back
        waits for it)."""
        h, w = left_u8.shape[:2]
        left = pad_to_next_multiple(normalize_image(left_u8))[None]
        right = pad_to_next_multiple(normalize_image(right_u8))[None]
        t0 = time.perf_counter()
        with torch.inference_mode(), fp32_precision():
            lt = torch.from_numpy(left).to(self.device)
            rt = torch.from_numpy(right).to(self.device)
            out = self.model(lt, rt)
            # ESMStereo returns [disparity]; the confidence model a pair
            maps = [m.cpu().float().numpy() for m in out]
        dt = time.perf_counter() - t0
        hi, wi = left.shape[1:3]
        maps = [m[0, hi - h:, wi - w:] for m in maps]
        return (maps[0] if len(maps) == 1 else tuple(maps)), dt
