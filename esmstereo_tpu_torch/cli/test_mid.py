"""Middlebury training-scene evaluator (bad-2.0 and EPE, occlusion-masked).

The port's counterpart of ``tools/test_mid.py`` (the reference's
``test_mid.py:70-138``): each scene directory of ``--datapath`` holds
``im0.png``, ``im1.png``, ``disp0GT.pfm`` and optionally
``mask0nocc.png`` (255 = non-occluded).

    python -m esmstereo_tpu_torch.cli.test_mid --datapath MiddEval3/trainingQ
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
    p = argparse.ArgumentParser(description="ESMStereo Middlebury eval "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--datapath", required=True,
                   help="root with per-scene dirs (im0/im1.png, disp0GT.pfm)")
    p.add_argument("--bad_thresh", type=float, default=2.0)
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

    scenes = bl.middlebury_paths(args.datapath)
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

            h, w = gt.shape
            invalid = (gt <= 0) | (gt >= args.maxdisp)
            if maskp:
                invalid |= ~bl.load_nocc_mask(maskp)
            err = np.abs(pred - gt)
            err[invalid] = 0
            denom = max(h * w - int(invalid.sum()), 1)
            bad = float(np.sum(err > args.bad_thresh) / denom)
            epe = float(np.sum(err) / denom)
            bad_sum += bad
            epe_sum += epe
            print(f"Bad {os.path.dirname(lp).split('/')[-1]}: {bad:.4f} "
                  f"EPE {epe:.3f}  {dt * 1e3:.1f}ms")

    n = len(scenes)
    print(f"Bad {args.bad_thresh}", bad_sum / n * 100)
    print("EPE", epe_sum / n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
