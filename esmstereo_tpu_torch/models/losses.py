"""Training and eval losses.

Counterpart of ``esmstereo_tpu/models/losses.py`` (the reference's
``models/loss.py``): multi-scale masked smooth-L1 with per-scale weights

  * cv4:  [1, 1/6]        over [full, 1/2]
  * cv8:  [1, 1/6, 1/10]  over [full, 1/2, 1/4]
  * cv16: [1, 0.5], but the reference's ``disp_gts[0:2:3]`` slice yields a
    single element, so zip truncates and only the full-res output is
    supervised (``loss.py:19``); ``fix_cv16`` restores the intended
    [full, 1/4] pairing.

Masked means are ``sum(loss * mask) / max(sum(mask), 1)``: the reference's
boolean-indexed mean on a non-empty mask, and 0 (not NaN) on an empty one.
"""

from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, beta 1) of a residual."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def disparity_masks(disp_gts: list[torch.Tensor], max_disp: int
                    ) -> list[torch.Tensor]:
    """Validity masks ``0 < gt < max_disp`` (``train_sceneflow.py:209-212``)."""
    return [(g > 0) & (g < max_disp) for g in disp_gts]


_WEIGHTS = {4: (1.0, 1.0 / 6), 8: (1.0, 1.0 / 6, 1.0 / 10), 16: (1.0, 0.5)}


def model_loss_train(disp_ests: list[torch.Tensor],
                     disp_gts: list[torch.Tensor],
                     masks: list[torch.Tensor], cv_scale: int,
                     fix_cv16: bool = False) -> torch.Tensor:
    """Multi-scale weighted masked smooth-L1 (``loss.py:3-22``):
    ``disp_ests`` as the model returns them in training, ``disp_gts`` the
    full-res GT then the /2, /4, /8, /16 ones, ``masks`` theirs."""
    weights = _WEIGHTS[cv_scale]
    if cv_scale == 16:
        # the reference's [0:2:3] keeps the full-res pair only
        sel = [0, 2] if fix_cv16 else [0]
    else:
        sel = list(range(len(weights)))
    total = disp_ests[0].new_zeros(())
    for est, i, w in zip(disp_ests, sel, weights):
        total = total + w * masked_mean(smooth_l1(est - disp_gts[i]),
                                        masks[i])
    return total


def model_loss_test(disp_ests: list[torch.Tensor],
                    disp_gts: list[torch.Tensor],
                    masks: list[torch.Tensor]) -> torch.Tensor:
    """Masked L1 on the full-res output only (``loss.py:24-29``)."""
    return masked_mean(torch.abs(disp_ests[0] - disp_gts[0]), masks[0])
