"""KITTI 2012/2015 training-split evaluator.

The port's counterpart of ``tools/test_kitti.py`` (the reference's
``test_kitti.py``): runs the 200-image training split (the 160 train and
40 val partitions together) through ``eval.runner.InferenceRunner``, which
pads each image top-left to the next multiple of 32; reports EPE and the
>3px rate, and optionally writes colormapped disparity, GT and error-map
PNGs.

    python -m esmstereo_tpu_torch.cli.test_kitti --datapath KITTI/training \\
        --loadckpt logs/kitti/checkpoint_000599 [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from esmstereo_tpu_torch.cli.common import (add_model_args,
                                            apply_runtime_flags,
                                            build_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ESMStereo KITTI evaluation "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--datapath", required=True,
                   help="KITTI training root (with image_2/ or colored_0/)")
    p.add_argument("--kitti", default="2015", choices=["2015", "2012"])
    p.add_argument("--loadckpt", default="",
                   help="a checkpoint of the port's training CLIs")
    p.add_argument("--save_dir", default="",
                   help="write error/gt/disp PNGs here (empty: skip)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from esmstereo_tpu_torch.data import benchmark_loaders as bl
    from esmstereo_tpu_torch.data.png import write_png
    from esmstereo_tpu_torch.eval.runner import (InferenceRunner,
                                                 load_model_for_eval,
                                                 masked_epe_and_rate)
    from esmstereo_tpu_torch.utils.visualization import (colorize_disparity,
                                                         error_map)

    if args.kitti == "2015":
        train, val = bl.kitti_2015_paths(args.datapath)
    else:
        train, val = bl.kitti_2012_paths(args.datapath)
    triples = train + val
    if args.limit:
        triples = triples[: args.limit]
    if not triples:
        raise FileNotFoundError(f"no images found under {args.datapath}")

    with apply_runtime_flags(args) as device:
        run = InferenceRunner(load_model_for_eval(build_config(args),
                                                  args.loadckpt, device))
        if args.save_dir:
            for sub in ("error", "gt", "disp"):
                os.makedirs(os.path.join(args.save_dir, sub), exist_ok=True)

        total_epe, total_rate, total_time = 0.0, 0.0, 0.0
        for i, (lp, rp, dp) in enumerate(triples):
            left = bl.load_image_u8(lp)
            right = bl.load_image_u8(rp)
            gt = bl.load_kitti_disp(dp)
            pred, dt = run(left, right)
            total_time += dt

            mask = (gt > 0) & (gt < args.maxdisp)
            epe, rate = masked_epe_and_rate(pred, gt, mask, 3.0)
            total_epe += epe
            total_rate += rate
            print(f"[{i + 1}/{len(triples)}] {os.path.basename(lp)} "
                  f"EPE {epe:.3f}  >3px {rate:.4f}  {dt * 1e3:.1f}ms")

            if args.save_dir:
                name = os.path.basename(lp)
                write_png(os.path.join(args.save_dir, "error", name),
                          (error_map(pred, gt) * 255).astype(np.uint8))
                write_png(os.path.join(args.save_dir, "disp", name),
                          colorize_disparity(pred, args.maxdisp))
                write_png(os.path.join(args.save_dir, "gt", name),
                          colorize_disparity(gt, args.maxdisp))

    n = len(triples)
    print("#### EPE", total_epe / n)
    print("#### >3.0", total_rate / n)
    print(f"#### mean forward {total_time / n * 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
