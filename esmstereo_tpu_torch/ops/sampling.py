"""Resampling ops on NCHW tensors.

Counterpart of ``esmstereo_tpu/ops/sampling.py`` for the ops the L eval
path uses: bilinear resize with half-pixel centres, legacy-nearest resize
and torch-order pixel shuffle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (``align_corners=False``),
    as ``jax.image.resize(method='linear')`` does when it upsamples."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with source index ``floor(dst * src / dst)`` (torch's
    legacy ``mode='nearest'``, the ``Conv2x`` shape fix-up)."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    rows = torch.arange(h_out, device=x.device) * h_in // h_out
    cols = torch.arange(w_out, device=x.device) * w_in // w_out
    return x[..., rows, :][..., cols]


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space with ``nn.PixelShuffle`` channel order:
    ``(B, C*r*r, H, W) -> (B, C, H*r, W*r)``."""
    return F.pixel_shuffle(x, r)
