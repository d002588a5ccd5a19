"""Host-side rate of the data layer: PNG and PFM reads, one training
sample, and the loader's batches with threads and with forked processes.

    python -m esmstereo_tpu_torch.eval.data_rate [--pairs 8] [--repeat 8]
        [--workers 8] [--batch 4]

Writes, under a temporary directory, a SceneFlow tree (540x960, PFM GT)
and a KITTI-2015 tree (375x1242, uint16 GT) of ``make_scene_batch``
scenes, each PNG twice: with every row Paeth-filtered (the filter that
adaptive encoders such as libpng and PIL pick on nearly every row of a
natural image, so what a dataset's files hold) and unfiltered (what
``data.png.write_png`` stores). Prints ms per read, ms per SceneFlow
training sample (decode, augment, normalise), and the loader's samples a
second at batch ``--batch`` over ``--pairs`` pairs listed ``--repeat``
times, with ``--workers`` threads and then as many forked processes,
beside the host's CPU count. Host numbers only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import tempfile
import time
import zlib

import numpy as np

from esmstereo_tpu_torch.data import png
from esmstereo_tpu_torch.data.benchmark_loaders import load_kitti_disp
from esmstereo_tpu_torch.data.datasets import SceneFlowDataset
from esmstereo_tpu_torch.data.io import (denormalize_image, pfm_imread,
                                         pfm_imwrite)
from esmstereo_tpu_torch.data.loader import DataLoader
from esmstereo_tpu_torch.data.synthetic import make_scene_batch

SCENEFLOW = (540, 960)
KITTI = (375, 1242)


def write_png_paeth(path: str, img: np.ndarray) -> None:
    """``img`` (uint8 HxWxC or uint16 HxW) as a PNG whose every row is
    Paeth-filtered."""
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    x = raw.view(np.uint8).reshape(h, -1).astype(np.int16)
    bpp = x.shape[1] // w
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(a, ((1, 0), (0, 0)))[:-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    header = np.array([w, h], ">u4").tobytes() + bytes([depth, ctype, 0, 0,
                                                        0])
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", header)
                + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + png._chunk(b"IEND", b""))


def mean_ms(fn, paths) -> float:
    start = time.perf_counter()
    for p in paths:
        fn(p)
    return (time.perf_counter() - start) / len(paths) * 1e3


def write_trees(root: str, pairs: int, rng: np.random.Generator) -> dict:
    """The two trees; returns the files to read by kind."""
    files: dict = {k: [] for k in ("sf_paeth", "sf_plain", "kitti_paeth",
                                   "kitti_plain", "kitti_gt", "sf_pfm")}
    lines = []
    for frame, tag in ((SCENEFLOW, "sf"), (KITTI, "kitti")):
        b = make_scene_batch(rng, pairs, *frame, disp_range=(4, 96),
                             pyramid=False)
        for i in range(pairs):
            for eye in ("left", "right"):
                img = np.round(denormalize_image(b[eye][i]) * 255).astype(
                    np.uint8)
                paeth = os.path.join(root, tag, f"{eye}_{i}.png")
                plain = os.path.join(root, tag, f"{eye}_{i}_plain.png")
                os.makedirs(os.path.dirname(paeth), exist_ok=True)
                write_png_paeth(paeth, img)
                png.write_png(plain, img)
                files[f"{tag}_paeth"].append(paeth)
                files[f"{tag}_plain"].append(plain)
            disp = b["disparity"][i]
            if tag == "sf":
                pfm = os.path.join(root, tag, f"disp_{i}.pfm")
                pfm_imwrite(pfm, disp)
                files["sf_pfm"].append(pfm)
                lines.append(f"left_{i}.png right_{i}.png disp_{i}.pfm")
            else:
                gt = os.path.join(root, tag, f"gt_{i}.png")
                write_png_paeth(gt, np.round(disp * 256).astype(np.uint16))
                files["kitti_gt"].append(gt)
    files["sf_list_lines"] = lines
    return files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--repeat", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    root = tempfile.mkdtemp(prefix="data_rate_")
    try:
        start = time.perf_counter()
        files = write_trees(root, args.pairs,
                            np.random.default_rng(args.seed))
        listfile = os.path.join(root, "sceneflow.txt")
        with open(listfile, "w") as f:
            f.write("\n".join(files["sf_list_lines"] * args.repeat) + "\n")
        out = {"host_cpus": os.cpu_count(),
               "usable_cpus": len(os.sched_getaffinity(0)),
               "processor": platform.processor() or platform.machine(),
               "write_s": time.perf_counter() - start}
        for key, fn in (("sf_paeth", png.read_rgb), ("sf_plain", png.read_rgb),
                        ("kitti_paeth", png.read_rgb),
                        ("kitti_plain", png.read_rgb),
                        ("kitti_gt", load_kitti_disp),
                        ("sf_pfm", pfm_imread)):
            out[f"{key}_read_ms"] = mean_ms(fn, files[key])
        ds = SceneFlowDataset(os.path.join(root, "sf"), listfile,
                              training=True)
        start = time.perf_counter()
        for i in range(args.pairs):
            ds.get(i, np.random.default_rng(i))
        out["sf_train_sample_ms"] = (time.perf_counter() - start) \
            / args.pairs * 1e3
        for kind, processes in (("threads", False), ("processes", True)):
            loader = DataLoader(ds, args.batch, num_workers=args.workers,
                                use_processes=processes, seed=args.seed)
            start = time.perf_counter()
            n = sum(len(b["left"]) for b in loader)
            out[f"loader_{kind}_samples_per_s"] = \
                n / (time.perf_counter() - start)
        out.update(workers=args.workers, batch=args.batch,
                   samples=len(ds))
        for k, v in out.items():
            print(f"{k}: {v:.2f}" if isinstance(v, float) else f"{k}: {v}")
        print(json.dumps(out))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
