"""Disparity evaluation metrics (masked, per image, batch mean).

Counterpart of ``esmstereo_tpu/utils/metrics.py`` (the reference's
``utils/metrics.py``):

  * the metric per image over its mask, then the mean over the batch;
  * an image whose mask covers less than 10% of its positive-GT pixels is
    skipped (``metrics.py:26-27``); if every image is skipped the metric
    is 0.

Every function takes ``(d_est, d_gt, mask)`` of shape ``(B, H, W)`` and
returns a 0-d tensor, computed without a host sync (the skip is a weight).
"""

from __future__ import annotations

import torch


def _per_image_mean(values: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """Masked mean per image: (B, H, W) -> (B,)."""
    m = mask.to(values.dtype)
    return (torch.sum(values * m, dim=(1, 2))
            / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0))


def _image_weights(d_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.0 for images that pass the degenerate-mask check, else 0."""
    mask_frac = torch.mean(mask.float(), dim=(1, 2))
    pos_frac = torch.mean((d_gt > 0).float(), dim=(1, 2))
    ratio = mask_frac / torch.clamp(pos_frac, min=1e-12)
    return (ratio >= 0.1).float()


def _batch_mean(per_image: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    total = torch.sum(weights)
    mean = torch.sum(per_image * weights) / torch.clamp(total, min=1.0)
    return torch.where(total > 0, mean, torch.zeros_like(mean))


def _bad_fraction(bad: torch.Tensor, d_gt: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    return _batch_mean(_per_image_mean(bad.float(), mask),
                       _image_weights(d_gt, mask))


def epe_metric(d_est: torch.Tensor, d_gt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """End-point error: masked mean |est - gt| (``metrics.py:70-74``)."""
    err = torch.abs(d_est - d_gt)
    return _batch_mean(_per_image_mean(err, mask), _image_weights(d_gt, mask))


def d1_metric_thres(d_est: torch.Tensor, d_gt: torch.Tensor,
                    mask: torch.Tensor, thres: float) -> torch.Tensor:
    """D1 with a custom pixel threshold (``metrics.py:51-57``)."""
    err = torch.abs(d_est - d_gt)
    rel = err / torch.clamp(torch.abs(d_gt), min=1e-12)
    return _bad_fraction((err > thres) & (rel > 0.05), d_gt, mask)


def d1_metric(d_est: torch.Tensor, d_gt: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """D1: the share with err > 3 px AND err/|gt| > 5%
    (``metrics.py:42-48``)."""
    return d1_metric_thres(d_est, d_gt, mask, 3.0)


def thres_metric(d_est: torch.Tensor, d_gt: torch.Tensor,
                 mask: torch.Tensor, thres: float) -> torch.Tensor:
    """The share of masked pixels with err > thres (``metrics.py:60-67``)."""
    return _bad_fraction(torch.abs(d_est - d_gt) > thres, d_gt, mask)


def eval_metrics(d_est: torch.Tensor, d_gt: torch.Tensor,
                 mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """The five eval metrics (``train_sceneflow.py:246-250``)."""
    return {
        "EPE": epe_metric(d_est, d_gt, mask),
        "D1": d1_metric(d_est, d_gt, mask),
        "Thres1": thres_metric(d_est, d_gt, mask, 1.0),
        "Thres2": thres_metric(d_est, d_gt, mask, 2.0),
        "Thres3": thres_metric(d_est, d_gt, mask, 3.0),
    }
