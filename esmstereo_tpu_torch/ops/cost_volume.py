"""Correlation cost volumes in the unfolded layout: group-wise (gwc),
group-wise on L2-normalised groups (gwc_norm) and channel-normalised
(norm-correlation).

Counterpart of ``esmstereo_tpu/ops/cost_volume.py:50-85,97-128``. Features
are NCHW ``(B, C, H, W)``; the volume is ``(B, G, D, H, W)``, the layout the
3-D convs read (``G = 1`` for norm-correlation). For a shift ``d`` the left
pixel at column ``w`` meets the right pixel at ``w - d``; entries with
``w < d`` are zero, and stay zero after normalisation (``0 / (0 + eps)``).

The model builds the volume with ``ops.kernels.correlation``; this module
is its reference formulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-5


def l2_normalize_groups(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``x / (||x_g|| + 1e-5)`` for each pixel and group of channels."""
    b, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xg = x.view(b, num_groups, c // num_groups, h, w)
    norm = torch.linalg.vector_norm(xg, dim=2, keepdim=True)
    return (xg / (norm + _EPS)).view(b, c, h, w)


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group mean of the elementwise product: (B,C,H,W) -> (B,G,H,W)."""
    b, c, h, w = fea1.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    prod = (fea1 * fea2).view(b, num_groups, c // num_groups, h, w)
    return prod.mean(dim=2)


def groupwise_correlation_norm(fea1: torch.Tensor, fea2: torch.Tensor,
                               num_groups: int) -> torch.Tensor:
    """Per-group mean of the product of per-group L2-normalised features."""
    return groupwise_correlation(l2_normalize_groups(fea1, num_groups),
                                 l2_normalize_groups(fea2, num_groups),
                                 num_groups)


def norm_correlation(fea1: torch.Tensor, fea2: torch.Tensor) -> torch.Tensor:
    """Mean of the product of channel-normalised features: (B,1,H,W)."""
    return groupwise_correlation_norm(fea1, fea2, 1)


def _shifted_planes(corr, ref: torch.Tensor, tgt: torch.Tensor,
                    max_disp: int) -> torch.Tensor:
    """``stack([corr(ref, tgt shifted right by d) for d < max_disp], 2)``,
    the shift as one left pad of the target and static slices."""
    w = tgt.shape[-1]
    padded = F.pad(tgt, (max_disp - 1, 0))
    off = max_disp - 1
    return torch.stack([corr(ref, padded[..., off - d:off - d + w])
                        for d in range(max_disp)], dim=2)


def build_gwc_volume(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume ``(B, G, D, H, W)``."""
    return _shifted_planes(
        lambda a, b: groupwise_correlation(a, b, num_groups), ref, tgt,
        max_disp)


def build_gwc_volume_norm(ref: torch.Tensor, tgt: torch.Tensor,
                          max_disp: int, num_groups: int) -> torch.Tensor:
    """Group-wise correlation of per-group L2-normalised features,
    ``(B, G, D, H, W)``. Normalising per pixel commutes with the shift, so
    each map is normalised once."""
    return build_gwc_volume(l2_normalize_groups(ref, num_groups),
                            l2_normalize_groups(tgt, num_groups), max_disp,
                            num_groups)


def build_norm_correlation_volume(ref: torch.Tensor, tgt: torch.Tensor,
                                  max_disp: int) -> torch.Tensor:
    """Channel-normalised correlation volume ``(B, 1, D, H, W)``."""
    return build_gwc_volume_norm(ref, tgt, max_disp, 1)
