"""Eval-mode inference on a uint8 stereo pair.

Counterpart of ``esmstereo_tpu/eval/runner.py``: normalise, pad each image
top-left up to the NEXT multiple of 32 (zero fill, as the reference's PIL
crop with negative offsets), run the model, cut the padding off.
"""

from __future__ import annotations

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


class InferenceRunner:
    """uint8 HWC pair -> disparity map, on the model's device."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.model = model.eval()
        self.device = next(model.parameters()).device

    def __call__(self, left_u8: np.ndarray, right_u8: np.ndarray
                 ) -> tuple[np.ndarray, float]:
        """Return (disparity H x W float32, wall seconds). The time covers
        the host-to-device copy, the forward pass and the copy back, and
        ends after the device has finished (the copy back waits for it)."""
        h, w = left_u8.shape[:2]
        left = pad_to_next_multiple(normalize_image(left_u8))[None]
        right = pad_to_next_multiple(normalize_image(right_u8))[None]
        t0 = time.perf_counter()
        with torch.inference_mode():
            lt = torch.from_numpy(left).to(self.device)
            rt = torch.from_numpy(right).to(self.device)
            disp = self.model(lt, rt)[0].cpu().numpy()
        dt = time.perf_counter() - t0
        hi, wi = left.shape[1:3]
        return disp[0, hi - h:, wi - w:], dt
