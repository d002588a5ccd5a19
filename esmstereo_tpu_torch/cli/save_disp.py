"""KITTI benchmark submission writer.

The port's counterpart of ``tools/save_disp.py`` (the reference's
``save_disp.py``): runs the KITTI test split (no GT) through
``eval.runner.InferenceRunner``, which cuts the padding off the
predictions, and writes uint16 ``round(clip(disparity, 0, 255) * 256)``
PNGs, ready for leaderboard submission.

    python -m esmstereo_tpu_torch.cli.save_disp --datapath KITTI/testing \\
        --loadckpt logs/kitti/checkpoint_000599 --outdir predictions
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np

from esmstereo_tpu_torch.cli.common import (add_model_args,
                                            apply_runtime_flags,
                                            build_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ESMStereo submission writer "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--datapath", required=True,
                   help="KITTI testing root (with image_2/ or colored_0/)")
    p.add_argument("--kitti", default="2015", choices=["2015", "2012"])
    p.add_argument("--loadckpt", default="",
                   help="a checkpoint of the port's training CLIs")
    p.add_argument("--outdir", default="./predictions")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from esmstereo_tpu_torch.data import benchmark_loaders as bl
    from esmstereo_tpu_torch.data.png import write_png
    from esmstereo_tpu_torch.eval.runner import (InferenceRunner,
                                                 load_model_for_eval)

    img_l = "image_2" if args.kitti == "2015" else "colored_0"
    img_r = "image_3" if args.kitti == "2015" else "colored_1"
    lefts = sorted(glob(os.path.join(args.datapath, img_l, "*_10.png")))
    if args.limit:
        lefts = lefts[: args.limit]
    if not lefts:
        raise FileNotFoundError(f"no images under {args.datapath}/{img_l}")

    with apply_runtime_flags(args) as device:
        run = InferenceRunner(load_model_for_eval(build_config(args),
                                                  args.loadckpt, device))
        os.makedirs(args.outdir, exist_ok=True)
        for i, lp in enumerate(lefts):
            rp = lp.replace(img_l, img_r)
            left = bl.load_image_u8(lp)
            right = bl.load_image_u8(rp)
            pred, dt = run(left, right)
            out = np.round(np.clip(pred, 0, 255) * 256).astype(np.uint16)
            name = os.path.basename(lp)
            write_png(os.path.join(args.outdir, name), out)
            print(f"[{i + 1}/{len(lefts)}] {name}  {dt * 1e3:.1f}ms")

    print(f"wrote {len(lefts)} predictions to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
