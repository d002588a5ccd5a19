"""Stereo-pair augmentations (numpy, host-side).

The port's own copy of ``esmstereo_tpu/data/transforms.py:27-149``, the
reference's training augmentation set (``sceneflow_dataset.py:55-121``,
``kitti_dataset.py:71-132``, ``flow_transforms.py``):

  * asymmetric chromatic aug: brightness, gamma, contrast and saturation
    drawn independently per eye (torchvision-PIL formulas on uint8);
  * joint random crop of left, right and disparity;
  * right-eye random occlusion patch filled with the mean colour;
  * nearest-downsampled GT disparity pyramid at /2 /4 /8 /16 (values in
    full-resolution units).

Every function takes an explicit ``np.random.Generator``; with the same
generator state each gives the JAX package's arrays. Not copied:
``random_vdisp`` and ``scale_pair``, which nothing calls and which need
OpenCV's ``warpAffine`` and bicubic ``resize``.
"""

from __future__ import annotations

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float64)


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


# brightness, gamma and contrast are per-value uint8 -> uint8 maps, so each
# runs as a 256-entry LUT gather; applied one after the other they quantize
# to uint8 between steps, so composing their LUTs is bit-exact.


def _lut_brightness(factor: float) -> np.ndarray:
    """PIL ImageEnhance.Brightness: blend with black."""
    return _to_uint8(np.arange(256, dtype=np.float64) * factor)


def _lut_gamma(gamma: float, gain: float = 1.0) -> np.ndarray:
    """torchvision adjust_gamma: 255 * gain * (img/255)**gamma."""
    return _to_uint8(
        255.0 * gain * (np.arange(256, dtype=np.float64) / 255.0) ** gamma)


def _lut_contrast(factor: float, mean: float) -> np.ndarray:
    return _to_uint8(
        (np.arange(256, dtype=np.float64) - mean) * factor + mean)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Brightness: blend with black."""
    return _lut_brightness(factor)[img]


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    """torchvision adjust_gamma: 255 * gain * (img/255)**gamma."""
    return _lut_gamma(gamma, gain)[img]


def _grayscale(img: np.ndarray) -> np.ndarray:
    """PIL 'L' conversion: floor of the weighted sum."""
    return (img.astype(np.float64) @ _GRAY).astype(np.uint8)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Contrast: blend with the mean of the grayscale image."""
    mean = round(_grayscale(img).mean() + 0.5)  # PIL uses int(mean + 0.5)
    return _lut_contrast(factor, mean)[img]


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Color: blend with the grayscale image, as one
    256 x 256 LUT gather over the (gray, value) uint8 pair."""
    gray = _grayscale(img)
    v = np.arange(256, dtype=np.float64)
    lut2 = _to_uint8((v[None, :] - v[:, None]) * factor + v[:, None])
    return lut2[gray[..., None], img]


def asymmetric_chromatic_aug(rng: np.random.Generator, left: np.ndarray,
                             right: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-eye independent photometric jitter (``sceneflow_dataset.py:58-89``):
    brightness and gamma as one LUT, then contrast (its blend mean taken on
    the post-gamma image, as PIL does), then saturation."""
    brightness = rng.uniform(0.5, 2.0, 2)
    gamma = rng.uniform(0.8, 1.2, 2)
    contrast = rng.uniform(0.8, 1.2, 2)
    saturation = rng.uniform(0.0, 1.4, 2)
    out = []
    for i, img in enumerate((left, right)):
        lut_bg = _lut_gamma(gamma[i])[_lut_brightness(brightness[i])]
        img = lut_bg[img]
        img = adjust_contrast(img, contrast[i])
        img = adjust_saturation(img, saturation[i])
        out.append(img)
    return out[0], out[1]


def random_crop(rng: np.random.Generator, left: np.ndarray, right: np.ndarray,
                disp: np.ndarray, size: tuple[int, int]):
    """Joint random crop (``flow_transforms.py:53-74``)."""
    h, w = left.shape[:2]
    th, tw = min(size[0], h), min(size[1], w)
    x1 = int(rng.integers(0, w - tw + 1))
    y1 = int(rng.integers(0, h - th + 1))
    return (left[y1:y1 + th, x1:x1 + tw],
            right[y1:y1 + th, x1:x1 + tw],
            disp[y1:y1 + th, x1:x1 + tw])


def random_occlusion_patch(rng: np.random.Generator, right: np.ndarray,
                           prob: float) -> np.ndarray:
    """Fill a random right-eye rectangle with the mean colour
    (``sceneflow_dataset.py:109-116``; prob 0.5 SceneFlow, 0.2 KITTI)."""
    if rng.binomial(1, prob):
        right = right.copy()
        sx = int(rng.uniform(35, 100))
        sy = int(rng.uniform(25, 75))
        # the reference assumes >= 200x150 crops; clamped so that small
        # images work too
        sx = min(sx, (right.shape[0] - 1) // 2)
        sy = min(sy, (right.shape[1] - 1) // 2)
        cx = int(rng.uniform(sx, right.shape[0] - sx))
        cy = int(rng.uniform(sy, right.shape[1] - sy))
        right[cx - sx:cx + sx, cy - sy:cy + sy] = np.mean(
            np.mean(right, 0), 0)[np.newaxis, np.newaxis]
    return right


def disparity_pyramid(disp: np.ndarray,
                      factors=(2, 4, 8, 16)) -> list[np.ndarray]:
    """Nearest-downsampled GT pyramid in full-res disparity units: cv2's
    INTER_NEAREST maps ``dst -> floor(dst * scale)``, a strided slice for
    integer factors (``sceneflow_dataset.py:119-121``)."""
    return [np.ascontiguousarray(disp[::f, ::f]) for f in factors]
