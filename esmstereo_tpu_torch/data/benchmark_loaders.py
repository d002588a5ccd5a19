"""Directory-scan loaders for the evaluation benchmarks.

The port's own copy of ``esmstereo_tpu/data/benchmark_loaders.py`` (the
reference's ``KITTI2012loader.py``, ``KITTI2015loader.py``,
``ETH3D_loader.py``, ``middlebury_loader.py``, ``KITTIRawLoader.py``),
reading PNG files through ``data.png``: lists of file paths (a train/val
split where the benchmark has one) and readers of the GT.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from esmstereo_tpu_torch.data import png
from esmstereo_tpu_torch.data.io import pfm_imread

KITTI_SPLIT = 160  # 160 train / 40 val (KITTI2015loader.py:38-40)


def _sorted_glob(pattern: str) -> list[str]:
    return sorted(glob(pattern))


def kitti_2015_paths(root: str):
    """(train, val) lists of (left, right, disp) from a KITTI-2015 root."""
    left = _sorted_glob(os.path.join(root, "image_2", "*_10.png"))
    right = [p.replace("image_2", "image_3") for p in left]
    disp = [p.replace("image_2", "disp_occ_0") for p in left]
    trips = list(zip(left, right, disp))
    return trips[:KITTI_SPLIT], trips[KITTI_SPLIT:]


def kitti_2012_paths(root: str):
    """(train, val) lists of (left, right, disp) from a KITTI-2012 root."""
    left = _sorted_glob(os.path.join(root, "colored_0", "*_10.png"))
    right = [p.replace("colored_0", "colored_1") for p in left]
    disp = [p.replace("colored_0", "disp_occ") for p in left]
    trips = list(zip(left, right, disp))
    return trips[:KITTI_SPLIT], trips[KITTI_SPLIT:]


def kitti_raw_paths(root: str, date: str, drive: str):
    """Raw KITTI stereo sequence (video demo, ``KITTIRawLoader.py:20-33``)."""
    seq = os.path.join(root, date, f"{date}_drive_{drive}_sync")
    left = _sorted_glob(os.path.join(seq, "image_02", "data", "*.png"))
    right = [p.replace("image_02", "image_03") for p in left]
    return list(zip(left, right))


def _scene_paths(root: str):
    """(left, right, gt_pfm or None, nocc_mask or None) of each scene
    directory of ``root`` that holds ``im0.png`` and ``im1.png``."""
    out = []
    for s in _sorted_glob(os.path.join(root, "*")):
        l, r = os.path.join(s, "im0.png"), os.path.join(s, "im1.png")
        gt = os.path.join(s, "disp0GT.pfm")
        mask = os.path.join(s, "mask0nocc.png")
        if os.path.exists(l) and os.path.exists(r):
            out.append((l, r, gt if os.path.exists(gt) else None,
                        mask if os.path.exists(mask) else None))
    return out


def eth3d_paths(root: str):
    """ETH3D two-view training scenes: (left, right, gt_pfm, nocc_mask)."""
    return _scene_paths(root)


def middlebury_paths(root: str):
    """Middlebury training scenes: (left, right, gt_pfm, nocc_mask)."""
    return _scene_paths(root)


def load_image_u8(path: str) -> np.ndarray:
    return png.read_rgb(path)


def load_kitti_disp(path: str) -> np.ndarray:
    """KITTI GT disparity: the uint16 PNG / 256 (0 where invalid)."""
    return png.read_png(path).astype(np.float32) / 256.0


def load_pfm_disp(path: str) -> np.ndarray:
    """A PFM disparity map, its non-finite entries (invalid) set to 0."""
    disp, _ = pfm_imread(path)
    disp = np.ascontiguousarray(disp, dtype=np.float32)
    disp[~np.isfinite(disp)] = 0.0
    return disp


def load_nocc_mask(path: str) -> np.ndarray:
    """Non-occluded mask: white (255) = valid non-occluded pixel."""
    return png.read_png(path) == 255


def crop_to_multiple(img: np.ndarray, multiple: int = 32) -> np.ndarray:
    """Crop bottom/right so H and W divide ``multiple``
    (eval convention, ``test_kitti.py:93-97``)."""
    h, w = img.shape[:2]
    return img[: h - h % multiple, : w - w % multiple]
