"""Resampling ops on NCHW tensors.

Counterpart of ``esmstereo_tpu/ops/sampling.py`` for the ops the eval
paths use: bilinear resize with half-pixel centres, legacy-nearest resize,
torch-order pixel shuffle, and the confidence head's 3x3 unfold, context
upsampling and bilinear grid sampling. ``warp`` is not ported yet.
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


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhoods with zero padding 1: ``(B, 1, H, W) -> (B, 9, H,
    W)``, taps row-major over ``(dy, dx) in (-1, 0, 1)^2`` (``F.unfold``'s
    order for one channel)."""
    if x.ndim != 4 or x.shape[1] != 1:
        raise ValueError(f"unfold3x3 takes (B, 1, H, W), got {tuple(x.shape)}")
    b, _, h, w = x.shape
    return F.unfold(x, 3, padding=1).view(b, 9, h, w)


def context_upsample(depth_low: torch.Tensor, up_weights: torch.Tensor,
                     scale: int) -> torch.Tensor:
    """Each pixel of the ``scale``-times finer grid is the ``up_weights``
    combination of its parent pixel's 3x3 neighbourhood:
    ``(B, 1, H, W)`` and ``(B, 9, H*s, W*s)`` -> ``(B, 1, H*s, W*s)``."""
    h, w = depth_low.shape[2:]
    taps = resize_nearest(unfold3x3(depth_low), (h * scale, w * scale))
    return torch.sum(taps * up_weights, dim=1, keepdim=True)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool) -> torch.Tensor:
    """Bilinear sampling of ``x`` (B, C, H, W) at the normalised coordinates
    of ``grid`` (B, Ho, Wo, 2), ``grid[..., 0]`` the width coordinate and
    ``grid[..., 1]`` the height one, both in [-1, 1]; taps outside the map
    read zero. -> (B, C, Ho, Wo) in ``x``'s dtype. A bf16 ``x`` on an fp32
    grid is weighed in fp32 and rounded once, as the jnp function does."""
    dt = torch.promote_types(x.dtype, grid.dtype)
    y = F.grid_sample(x.to(dt), grid.to(dt), mode="bilinear",
                      padding_mode="zeros", align_corners=align_corners)
    return y.to(x.dtype)
