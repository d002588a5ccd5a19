"""Data I/O: normalisation, list files, PFM files.

The port's own copy of ``esmstereo_tpu/data/io.py`` (numpy only).
"""

from __future__ import annotations

import re

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8/float HWC RGB -> ImageNet-normalised float32 HWC."""
    img = np.asarray(img, dtype=np.float32)
    if img.max() > 1.5:  # uint8 range
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(img: np.ndarray) -> np.ndarray:
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def read_all_lines(filename: str) -> list[str]:
    with open(filename) as f:
        return [line.rstrip() for line in f if line.strip()]


def pfm_imread(filename: str) -> tuple[np.ndarray, float]:
    """Read a PFM file: ``(image, scale)``, the image top row first.

    ``PF`` is 3-channel, ``Pf`` grey; a negative scale marks little-endian
    data, a positive one big-endian."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dims = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data), scale


def pfm_imwrite(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a PFM file (counterpart of :func:`pfm_imread`): float32 in
    the host's byte order, under a negative scale."""
    image = np.asarray(image, dtype=np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        endian_scale = -scale if image.dtype.byteorder in ("<", "=") else scale
        f.write(f"{endian_scale}\n".encode("ascii"))
        np.flipud(image).tofile(f)
