"""Generate dataset list files by scanning a dataset root.

The port's counterpart of ``tools/make_filelists.py`` (the reference ships
static lists, ``filenames/*.txt``):

  * sceneflow: scans ``frames_finalpass/{TRAIN,TEST}`` + ``disparity``;
  * kitti15 / kitti12: scans ``training/`` image pairs + GT;
  * kitti_raw: scans a raw drive's ``image_02/image_03``.

    python -m esmstereo_tpu_torch.cli.make_filelists kitti15 ROOT -o LIST
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob


def sceneflow(root: str, split: str) -> list[str]:
    lines = []
    pattern = os.path.join(root, "frames_finalpass", split.upper(),
                           "*", "*", "left", "*.png")
    for left in sorted(glob(pattern)):
        right = left.replace("/left/", "/right/")
        rel = os.path.relpath(left, root)
        disp = rel.replace("frames_finalpass", "disparity").replace(
            ".png", ".pfm")
        if os.path.exists(right) and os.path.exists(os.path.join(root, disp)):
            lines.append(f"{rel} {os.path.relpath(right, root)} {disp}")
    return lines


def kitti(root: str, year: int) -> list[str]:
    img_l = "image_2" if year == 2015 else "colored_0"
    img_r = "image_3" if year == 2015 else "colored_1"
    disp = "disp_occ_0" if year == 2015 else "disp_occ"
    lines = []
    for left in sorted(glob(os.path.join(root, "training", img_l, "*_10.png"))):
        rel = os.path.relpath(left, root)
        lines.append(" ".join([
            rel, rel.replace(img_l, img_r), rel.replace(img_l, disp)]))
    return lines


def kitti_raw(root: str) -> list[str]:
    lines = []
    for left in sorted(glob(os.path.join(root, "image_02", "data", "*.png"))):
        rel = os.path.relpath(left, root)
        lines.append(f"{rel} {rel.replace('image_02', 'image_03')}")
    return lines


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["sceneflow_train", "sceneflow_test",
                                    "kitti15", "kitti12", "kitti_raw"])
    p.add_argument("root")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("--val_split", type=int, default=160,
                   help="KITTI train/val boundary (kept for the JAX tool's "
                        "flags; the lists hold every pair)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.kind == "sceneflow_train":
        lines = sceneflow(args.root, "train")
    elif args.kind == "sceneflow_test":
        lines = sceneflow(args.root, "test")
    elif args.kind == "kitti15":
        lines = kitti(args.root, 2015)
    elif args.kind == "kitti12":
        lines = kitti(args.root, 2012)
    else:
        lines = kitti_raw(args.root)

    text = "\n".join(lines) + "\n"
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {len(lines)} entries to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
