"""ETH3D two-view evaluator (bad-1.0 and EPE, with the mask0nocc masks).

The port's counterpart of ``tools/test_eth3d.py`` (the reference's
``test_eth3d.py:63-115``): each scene directory of ``--datapath`` holds
``im0.png``, ``im1.png``, ``disp0GT.pfm`` and optionally
``mask0nocc.png`` (255 = non-occluded).

    python -m esmstereo_tpu_torch.cli.test_eth3d --datapath ETH3D/two_view_training
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
    p = argparse.ArgumentParser(description="ESMStereo ETH3D eval "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--datapath", required=True)
    p.add_argument("--bad_thresh", type=float, default=1.0)
    p.add_argument("--loadckpt", default="",
                   help="a checkpoint of the port's training CLIs")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from esmstereo_tpu_torch.data import benchmark_loaders as bl
    from esmstereo_tpu_torch.eval.runner import (InferenceRunner,
                                                 load_model_for_eval)

    scenes = bl.eth3d_paths(args.datapath)
    if args.limit:
        scenes = scenes[: args.limit]
    if not scenes:
        raise FileNotFoundError(f"no scenes under {args.datapath}")

    with apply_runtime_flags(args) as device:
        run = InferenceRunner(load_model_for_eval(build_config(args),
                                                  args.loadckpt, device))
        bad_sum, epe_sum = 0.0, 0.0
        for lp, rp, gtp, maskp in scenes:
            left = bl.load_image_u8(lp)
            right = bl.load_image_u8(rp)
            gt = bl.load_pfm_disp(gtp)
            pred, dt = run(left, right)

            valid = (gt > 0) & (gt < args.maxdisp)
            if maskp:
                valid &= bl.load_nocc_mask(maskp)
            err = np.abs(pred - gt)
            bad = float(np.mean(err[valid] > args.bad_thresh))
            epe = float(np.mean(err[valid]))
            bad_sum += bad
            epe_sum += epe
            print(f"{os.path.dirname(lp).split('/')[-1]}: bad{args.bad_thresh} "
                  f"{bad:.4f} EPE {epe:.3f}  {dt * 1e3:.1f}ms")

    n = len(scenes)
    print(f"Bad {args.bad_thresh}", bad_sum / n * 100)
    print("EPE", epe_sum / n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
