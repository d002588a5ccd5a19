"""Disparity visualisation: KITTI-style error maps and colormapped disparity.

The port's own copy of ``esmstereo_tpu/utils/visualization.py`` (the
reference's ``utils/visualization.py``: the 10-bucket KITTI devkit error
colormap over ``min(err/3, rel_err/0.05)``, with a legend strip; output
HWC float in [0, 1]), and OpenCV's JET colormap as a table of its own.
"""

from __future__ import annotations

import numpy as np

# KITTI stereo devkit error-color buckets: (lo, hi) in units of the
# combined error ratio, and an RGB color.
_BUCKETS = np.array(
    [[0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
     [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
     [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
     [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
     [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
     [3 / 3.0, 6 / 3.0, 254, 224, 144],
     [6 / 3.0, 12 / 3.0, 253, 174, 97],
     [12 / 3.0, 24 / 3.0, 244, 109, 67],
     [24 / 3.0, 48 / 3.0, 215, 48, 39],
     [48 / 3.0, np.inf, 165, 0, 38]], dtype=np.float32)

# OpenCV's COLORMAP_JET lookup table (what ``cv2.applyColorMap`` gives for
# the values 0 ... 255), as 256 RGB triples
JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"), np.uint8).reshape(256, 3)


def gen_error_colormap() -> np.ndarray:
    cols = _BUCKETS.copy()
    cols[:, 2:5] /= 255.0
    return cols


def error_map(d_est: np.ndarray, d_gt: np.ndarray, abs_thres: float = 3.0,
              rel_thres: float = 0.05, legend: bool = True) -> np.ndarray:
    """Colormapped error image(s), NHWC float32 in [0, 1], of ``(B, H,
    W)`` or ``(H, W)`` inputs."""
    squeeze = d_gt.ndim == 2
    if squeeze:
        d_est, d_gt = d_est[None], d_gt[None]
    b, h, w = d_gt.shape
    cols = gen_error_colormap()

    mask = d_gt > 0
    err = np.abs(d_gt - d_est)
    ratio = np.zeros_like(err)
    ratio[mask] = np.minimum(err[mask] / abs_thres,
                             (err[mask] / d_gt[mask]) / rel_thres)

    image = np.zeros((b, h, w, 3), dtype=np.float32)
    for lo, hi, *rgb in cols:
        image[(ratio >= lo) & (ratio < hi)] = rgb
    image[~mask] = 0.0

    if legend:
        distance = 20
        for i in range(len(cols)):
            image[:, :10, i * distance:(i + 1) * distance] = cols[i, 2:]
    return image[0] if squeeze else image


def colorize_disparity(disp: np.ndarray, max_disp: float | None = None
                       ) -> np.ndarray:
    """JET-colormapped disparity (HWC uint8 RGB), as the demo writers use
    it (``save_vid.py:120-127`` applies cv2's COLORMAP_JET)."""
    if max_disp is None:
        max_disp = max(float(disp.max()), 1.0)
    norm = np.clip(disp / max_disp * 255.0, 0, 255).astype(np.uint8)
    return JET_RGB[norm]
