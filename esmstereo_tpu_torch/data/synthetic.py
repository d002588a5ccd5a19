"""Synthetic stereo data: textured pairs with exact known disparity.

The port's own copy of ``esmstereo_tpu/data/synthetic.py`` (numpy only),
plus ``SceneDataset``, a dataset of its layered scenes for
``data.loader.DataLoader``. For overfit and training tests, and the
training phase of ``chip_smoke.py``: no dataset download is needed. The
right view is the left view shifted by the disparity (``left[w] ==
right[w - d]``), so a correct model can drive EPE to ~0.
"""

from __future__ import annotations

import numpy as np

from esmstereo_tpu_torch.data.io import normalize_image


def _smooth_noise(rng: np.random.Generator, h: int, w: int, c: int,
                  scale: int = 8) -> np.ndarray:
    """Random texture with spatial structure (bilinear-upsampled noise)."""
    small = rng.random((h // scale + 2, w // scale + 2, c)).astype(np.float32)
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c_ = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c_ * fy * (1 - fx) + d * fy * fx)


def make_scene_batch(rng: np.random.Generator, batch: int, h: int, w: int,
                     n_layers: tuple[int, int] = (2, 5),
                     disp_range: tuple[int, int] = (4, 40),
                     pyramid: bool = True,
                     return_layers: bool = False,
                     return_raw: bool = False) -> dict:
    """Layered fronto-parallel scenes with exact piecewise-constant GT.

    Harder, geometrically consistent counterpart of :func:`make_batch`
    for the standing accuracy scoreboard (``tools/accuracy_scoreboard.py``):
    a background plane plus K rectangular foreground layers at strictly
    increasing integer disparities. Both views are composited back to
    front from per-layer wide canvases, so occlusion is handled exactly:
    a left-view pixel owned by layer k satisfies
    ``left[y, x] == right[y, x - d_k]`` whenever that right-view location
    is not covered by a nearer layer (verified in ``tests/test_data.py``).

    ``disp_range`` is half-open (numpy convention): layer disparities are
    drawn without replacement from ``[disp_range[0], disp_range[1])``, so
    at most ``disp_range[1] - disp_range[0]`` distinct layers fit; the
    requested layer count is clamped to that span.

    Returns the same dict layout as :func:`make_batch`.
    """
    span = disp_range[1] - disp_range[0]
    if span < 1:
        raise ValueError(f"empty disp_range {disp_range} (half-open)")
    lefts, rights, disps, layer_info = [], [], [], []
    for _ in range(batch):
        k = min(int(rng.integers(n_layers[0], n_layers[1] + 1)), span)
        ds = np.sort(rng.choice(
            np.arange(disp_range[0], disp_range[1]),
            size=k, replace=False)).astype(int)
        left = np.zeros((h, w, 3), np.float32)
        right = np.zeros((h, w, 3), np.float32)
        gt = np.zeros((h, w), np.float32)
        for li, d in enumerate(ds):
            canvas = _smooth_noise(rng, h, w + int(d), 3,
                                   scale=int(rng.integers(4, 13)))
            canvas += 0.1 * rng.standard_normal(canvas.shape).astype(
                np.float32)
            canvas = np.clip(canvas, 0, 1)
            if li == 0:                       # background covers the frame
                mask = np.ones((h, w), bool)
            else:
                bh = int(rng.integers(h // 6, h // 2))
                bw = int(rng.integers(w // 6, w // 2))
                y0 = int(rng.integers(0, h - bh))
                x0 = int(rng.integers(0, w - bw))
                mask = np.zeros((h, w), bool)
                mask[y0:y0 + bh, x0:x0 + bw] = True
            # canvas index == left-image column; the right view samples
            # columns shifted by +d (right[x] = canvas[x + d])
            left[mask] = canvas[:, :w][mask]
            gt[mask] = float(d)
            # the layer's right-view footprint is its mask shifted left
            # by d (columns that fall off the image edge disappear)
            mask_r = np.zeros((h, w), bool)
            mask_r[:, : w - d] = mask[:, d:]
            if d == 0:
                mask_r = mask
            right[mask_r] = canvas[:, d:d + w][mask_r]
            if li == 0:
                sample_layers = []
            sample_layers.append((mask, int(d)))
        layer_info.append(sample_layers)
        lefts.append((left, normalize_image(left)))
        rights.append((right, normalize_image(right)))
        disps.append(gt)
    out = {
        "left": np.stack([n for _, n in lefts]),
        "right": np.stack([n for _, n in rights]),
        "disparity": np.stack(disps),
    }
    if return_raw:
        # un-normalized [0, 1] views, e.g. for writing uint8 PNGs that a
        # serving pipeline re-normalizes itself (tools/conf_e2e.py)
        out["left_raw"] = np.stack([r for r, _ in lefts])
        out["right_raw"] = np.stack([r for r, _ in rights])
    if pyramid:
        out["disparity_low"] = [
            out["disparity"][:, ::r, ::r] for r in (2, 4, 8, 16)
        ]
    if return_layers:
        out["layers"] = layer_info  # [(mask (H,W) bool, disparity int)]
    return out


def make_batch(rng: np.random.Generator, batch: int, h: int, w: int,
               max_disp: int = 192, disp_range: tuple[int, int] = (4, 20),
               pyramid: bool = True) -> dict:
    """Build a training batch dict (NHWC, ImageNet-normalised)."""
    lefts, rights, disps = [], [], []
    for _ in range(batch):
        d = int(rng.integers(disp_range[0], disp_range[1]))
        # generate a wide canvas and cut shifted views from it
        canvas = _smooth_noise(rng, h, w + d, 3)
        canvas += 0.1 * rng.standard_normal(canvas.shape).astype(np.float32)
        canvas = np.clip(canvas, 0, 1)
        # canvas index == left-image column: a scene point at left column
        # x appears at right column x - d, so right[x] = canvas[x + d]
        left = canvas[:, :w]
        right = canvas[:, d:]
        lefts.append(normalize_image(left))
        rights.append(normalize_image(right))
        disps.append(np.full((h, w), float(d), dtype=np.float32))
    out = {
        "left": np.stack(lefts),
        "right": np.stack(rights),
        "disparity": np.stack(disps),
    }
    if pyramid:
        out["disparity_low"] = [
            out["disparity"][:, ::r, ::r] for r in (2, 4, 8, 16)
        ]
    return out


class SceneDataset:
    """``length`` samples of ``make_scene_batch`` at ``h`` x ``w`` (each
    drawn from the rng the loader passes, which it keys by seed, epoch and
    index), with the /2 ... /16 GT pyramid in ``disparity_low``."""

    def __init__(self, length: int, h: int, w: int,
                 disp_range: tuple[int, int] = (4, 40)) -> None:
        self.length, self.h, self.w = length, h, w
        self.disp_range = disp_range

    def __len__(self) -> int:
        return self.length

    def get(self, index: int, rng: np.random.Generator) -> dict:
        b = make_scene_batch(rng, 1, self.h, self.w,
                             disp_range=self.disp_range)
        return {"left": b["left"][0], "right": b["right"][0],
                "disparity": b["disparity"][0],
                "disparity_low": [d[0] for d in b["disparity_low"]]}
