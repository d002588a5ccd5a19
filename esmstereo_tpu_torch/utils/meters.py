"""Running-average meters and scalar logging.

Counterpart of ``esmstereo_tpu/utils/meters.py`` (the reference's
``utils/experiment.py:64-77,128-169``: ``AverageMeter``,
``AverageMeterDict``, scalar names ``{mode}/{tag}_{idx}``).
"""

from __future__ import annotations

from typing import Union

import numpy as np

Scalars = dict[str, Union[float, list[float]]]


class AverageMeter:
    def __init__(self) -> None:
        self.sum_value = 0.0
        self.count = 0

    def update(self, x: float, n: int = 1) -> None:
        self.sum_value += float(x) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum_value / max(self.count, 1)

    def mean(self) -> float:
        return self.avg


class AverageMeterDict:
    """Sums of scalar and list-valued entries; ``mean()`` over updates."""

    def __init__(self) -> None:
        self.data: Scalars | None = None
        self.count = 0

    def update(self, x: Scalars) -> None:
        self.count += 1
        if self.data is None:
            self.data = {k: ([float(vi) for vi in v]
                             if isinstance(v, (list, tuple)) else float(v))
                         for k, v in x.items()}
            return
        for k, v in x.items():
            if isinstance(v, (list, tuple)):
                for i, vi in enumerate(v):
                    self.data[k][i] += float(vi)
            else:
                self.data[k] += float(v)

    def mean(self) -> Scalars:
        if self.data is None:
            raise ValueError("AverageMeterDict.mean: no update yet")
        return {k: ([vi / self.count for vi in v]
                    if isinstance(v, list) else v / self.count)
                for k, v in self.data.items()}


def save_scalars(logger, mode_tag: str, scalar_dict: Scalars,
                 global_step: int) -> None:
    """Each value as ``logger.add_scalar(f"{mode_tag}/{tag}_{idx}", value,
    global_step)``, the reference's names; nothing when ``logger`` is
    None. Any object with ``add_scalar`` will do (a TensorBoard
    ``SummaryWriter`` among them)."""
    if logger is None:
        return
    for tag, values in scalar_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            logger.add_scalar(f"{mode_tag}/{tag}_{idx}", float(value),
                              global_step)


def save_images(logger, mode_tag: str, images_dict: dict,
                global_step: int) -> None:
    """Image dump with per-image min-max normalisation (the reference's
    ``experiment.py:80-100``): HW or HWC numpy arrays (or lists of them;
    a batch gives its first element), named ``{mode}/{tag}[_{idx}]``,
    passed CHW to ``logger.add_image``; nothing when ``logger`` is None."""
    if logger is None:
        return
    for tag, values in images_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            img = np.asarray(value, dtype=np.float32)
            if img.ndim == 4:
                img = img[0]
            if img.ndim == 2:
                img = img[..., None]
            lo, hi = float(img.min()), float(img.max())
            img = (img - lo) / max(hi - lo, 1e-12)
            name = f"{mode_tag}/{tag}" + (f"_{idx}" if len(values) > 1
                                          else "")
            logger.add_image(name, np.transpose(img, (2, 0, 1)), global_step)
