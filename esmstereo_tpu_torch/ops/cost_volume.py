"""Group-wise correlation in the unfolded layout.

Counterpart of ``esmstereo_tpu/ops/cost_volume.py:50,97``. Features are
NCHW ``(B, C, H, W)``; the volume is ``(B, G, D, H, W)``, the layout the
3-D convs read. For a shift ``d`` the left pixel at column ``w`` meets the
right pixel at ``w - d``; entries with ``w < d`` are zero.

The model builds the volume with ``ops.kernels.correlation``; this module
is its reference formulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group mean of the elementwise product: (B,C,H,W) -> (B,G,H,W)."""
    b, c, h, w = fea1.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    prod = (fea1 * fea2).view(b, num_groups, c // num_groups, h, w)
    return prod.mean(dim=2)


def build_gwc_volume(ref: torch.Tensor, tgt: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume ``(B, G, D, H, W)``."""
    w = tgt.shape[-1]
    padded = F.pad(tgt, (max_disp - 1, 0))
    off = max_disp - 1
    planes = [groupwise_correlation(ref, padded[..., off - d:off - d + w],
                                    num_groups)
              for d in range(max_disp)]
    return torch.stack(planes, dim=2)
