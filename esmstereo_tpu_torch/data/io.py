"""Image normalisation (the port's own copy of ``esmstereo_tpu/data/io.py:13-22``)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8/float HWC RGB -> ImageNet-normalised float32 HWC."""
    img = np.asarray(img, dtype=np.float32)
    if img.max() > 1.5:  # uint8 range
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD
