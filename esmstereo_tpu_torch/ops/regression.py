"""Disparity regression on ``(B, D, H, W)`` cost volumes.

Counterpart of ``esmstereo_tpu/ops/regression.py``; disparity maps come
out as ``(B, 1, H, W)``.
"""

from __future__ import annotations

import torch


def disparity_regression(cost: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Weighted sum of the (raw) cost by bin index over axis 1."""
    if cost.ndim != 4 or cost.shape[1] != max_disp:
        raise ValueError(f"cost {tuple(cost.shape)} vs max_disp {max_disp}")
    disp = torch.arange(max_disp, dtype=cost.dtype,
                        device=cost.device).view(1, max_disp, 1, 1)
    return torch.sum(cost * disp, dim=1, keepdim=True)


def regression_topk(cost: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k softmax regression over the bin index: keep the ``k`` highest
    bins per pixel, softmax their costs, return the expected index.

    The reference's only use takes the bin index itself as the disparity
    sample (``ESMStereo.py:719-721``), so no sample volume is taken.
    """
    topv, topi = torch.topk(cost, k, dim=1)
    prob = torch.softmax(topv, dim=1)
    return torch.sum(topi.to(cost.dtype) * prob, dim=1, keepdim=True)
