"""SceneFlow and KITTI stereo datasets (list-file driven, host-side numpy).

The port's own copy of ``esmstereo_tpu/data/datasets.py`` (the reference's
``sceneflow_dataset.py`` and ``kitti_dataset.py``), reading PNG files
through ``data.png`` in place of PIL. Samples come out HWC float32
(ImageNet-normalised) with the GT disparity and, in training, its /2 ...
/16 nearest pyramid.
"""

from __future__ import annotations

import os

import numpy as np

from esmstereo_tpu_torch.data import png
from esmstereo_tpu_torch.data import transforms as T
from esmstereo_tpu_torch.data.benchmark_loaders import load_kitti_disp
from esmstereo_tpu_torch.data.io import (normalize_image, pfm_imread,
                                         read_all_lines)


def train_augment(rng: np.random.Generator, left: np.ndarray,
                  right: np.ndarray, disp: np.ndarray,
                  crop: tuple[int, int] = (256, 512),
                  occlusion_prob: float = 0.5) -> dict:
    """The shared training pipeline: chromatic aug -> crop -> occlusion ->
    pyramid -> normalise (``sceneflow_dataset.py:55-132``)."""
    left, right = T.asymmetric_chromatic_aug(rng, left, right)
    left, right, disp = T.random_crop(rng, left, right, disp, crop)
    right = T.random_occlusion_patch(rng, right, occlusion_prob)
    disp = np.ascontiguousarray(disp, dtype=np.float32)
    return {
        "left": normalize_image(left),
        "right": normalize_image(right),
        "disparity": disp,
        "disparity_low": T.disparity_pyramid(disp),
    }


class SceneFlowDataset:
    """SceneFlow (FlyingThings3D et al.) through a ``left right disp`` list
    file, paths relative to ``datapath``; the disparities are PFM files.

    Eval takes the bottom-right ``eval_crop`` (960x512,
    ``sceneflow_dataset.py:134-139``)."""

    def __init__(self, datapath: str, list_filename: str, training: bool,
                 crop: tuple[int, int] = (256, 512),
                 eval_crop: tuple[int, int] = (512, 960)) -> None:
        self.datapath = datapath
        self.training = training
        self.crop = crop
        self.eval_crop = eval_crop
        lines = [l.split() for l in read_all_lines(list_filename)]
        self.left_filenames = [x[0] for x in lines]
        self.right_filenames = [x[1] for x in lines]
        self.disp_filenames = [x[2] for x in lines]

    def __len__(self) -> int:
        return len(self.left_filenames)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        left = png.read_rgb(os.path.join(self.datapath,
                                         self.left_filenames[index]))
        right = png.read_rgb(os.path.join(self.datapath,
                                          self.right_filenames[index]))
        disp, _ = pfm_imread(os.path.join(self.datapath,
                                          self.disp_filenames[index]))
        disp = np.ascontiguousarray(disp, dtype=np.float32)

        if self.training:
            return train_augment(rng, left, right, disp, self.crop,
                                 occlusion_prob=0.5)

        h, w = left.shape[:2]
        ch, cw = self.eval_crop
        left = left[h - ch:, w - cw:]
        right = right[h - ch:, w - cw:]
        disp = disp[h - ch:, w - cw:]
        return {
            "left": normalize_image(left),
            "right": normalize_image(right),
            "disparity": disp,
            "top_pad": 0,
            "right_pad": 0,
        }


class KITTIDataset:
    """KITTI 2012 + 2015 through one list file.

    Routing: a second path component that starts with ``image`` (2015's
    ``image_2``) selects the 2015 root, any other (2012's ``colored_0``)
    the 2012 root (``kitti_dataset.py:52-56``). The GT disparity is a
    uint16 PNG / 256. Eval zero-pads to ``pad_to`` (384x1248, top and
    right) and returns the pad sizes for later un-padding."""

    def __init__(self, datapath_12: str, datapath_15: str, list_filename: str,
                 training: bool, crop: tuple[int, int] = (256, 512),
                 pad_to: tuple[int, int] = (384, 1248)) -> None:
        self.datapath_12 = datapath_12
        self.datapath_15 = datapath_15
        self.training = training
        self.crop = crop
        self.pad_to = pad_to
        lines = [l.split() for l in read_all_lines(list_filename)]
        self.left_filenames = [x[0] for x in lines]
        self.right_filenames = [x[1] for x in lines]
        self.disp_filenames = ([x[2] for x in lines]
                               if len(lines[0]) >= 3 else None)
        if training and self.disp_filenames is None:
            raise ValueError(f"{list_filename}: a training list needs a "
                             "disparity column")

    def __len__(self) -> int:
        return len(self.left_filenames)

    def _root(self, index: int) -> str:
        name = self.left_filenames[index].split("/")[1]
        return self.datapath_15 if name.startswith("image") else self.datapath_12

    def get(self, index: int, rng: np.random.Generator) -> dict:
        root = self._root(index)
        left = png.read_rgb(os.path.join(root, self.left_filenames[index]))
        right = png.read_rgb(os.path.join(root, self.right_filenames[index]))
        disp = None
        if self.disp_filenames is not None:
            disp = load_kitti_disp(os.path.join(root,
                                                self.disp_filenames[index]))

        if self.training:
            return train_augment(rng, left, right, disp, self.crop,
                                 occlusion_prob=0.2)

        h, w = left.shape[:2]
        ph, pw = self.pad_to
        top_pad, right_pad = ph - h, pw - w
        if top_pad < 0 or right_pad < 0:
            raise ValueError(f"{self.left_filenames[index]}: {h}x{w} is "
                             f"larger than pad_to {ph}x{pw}")

        def pad_img(x):
            return np.pad(x, ((top_pad, 0), (0, right_pad), (0, 0)))

        out = {
            "left": pad_img(normalize_image(left)),
            "right": pad_img(normalize_image(right)),
            "top_pad": top_pad,
            "right_pad": right_pad,
            "left_filename": self.left_filenames[index],
        }
        if disp is not None:
            out["disparity"] = np.pad(disp, ((top_pad, 0), (0, right_pad)))
        return out


__datasets__ = {
    "sceneflow": SceneFlowDataset,
    "kitti": KITTIDataset,
}
