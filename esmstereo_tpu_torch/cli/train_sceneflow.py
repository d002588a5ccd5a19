"""SceneFlow pretraining.

The port's counterpart of ``tools/train_sceneflow.py`` (the reference's
``train_sceneflow.py``): the same flags and recipe (AdamW lr 1e-3, batch
4, 60 epochs, LR/2 at epochs 20, 32, 40, 48 and 56, 256x512 crops) over
``train.loop.run_training``; ``--performance`` times the eval forward
with ``train.loop.measure_performance`` instead (on the card only).

    python -m esmstereo_tpu_torch.cli.train_sceneflow \\
        --datapath SceneFlow/flyingthings3d \\
        --trainlist filenames/sceneflow_train.txt \\
        --testlist filenames/sceneflow_test.txt --logdir logs/sceneflow
"""

from __future__ import annotations

import argparse
import sys

from esmstereo_tpu_torch.cli.common import (add_model_args, add_runtime_args,
                                            apply_runtime_flags, build_config,
                                            parse_hw, summary_writer)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ESMStereo SceneFlow training "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--dataset", default="sceneflow", choices=["sceneflow"])
    p.add_argument("--datapath", default="/datasets/SceneFlow/flyingthings3d")
    p.add_argument("--trainlist", default="./filenames/sceneflow_train.txt")
    p.add_argument("--testlist", default="./filenames/sceneflow_test.txt")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--test_batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lrepochs", type=str, default="20,32,40,48,56:2")
    p.add_argument("--logdir", default="./logs/sceneflow")
    p.add_argument("--loadckpt", default="",
                   help="a checkpoint to warm-start from (names and shapes "
                        "that match)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--performance", action="store_true",
                   help="time the eval forward at 512x960 and exit")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=1)
    p.add_argument("--image_freq", type=int, default=0,
                   help="TB image dumps every N steps (0=off)")
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--worker_processes", type=int, default=1,
                   help="1: forked loader workers (threads serialize on the "
                        "interpreter lock); 0: threads")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="H-sharding over several GPUs: 1 only (the port "
                        "runs on one)")
    p.add_argument("--fix_cv16_loss", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--crop", default="256,512",
                   help="training crop H,W (reference default 256,512; "
                        "smaller values for smoke tests)")
    p.add_argument("--eval_crop", default="512,960",
                   help="eval bottom-right crop H,W")
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from esmstereo_tpu_torch.data.datasets import SceneFlowDataset
    from esmstereo_tpu_torch.data.loader import DataLoader
    from esmstereo_tpu_torch.models import build_model
    from esmstereo_tpu_torch.train.loop import (TrainLoopConfig,
                                                measure_performance,
                                                run_training)
    from esmstereo_tpu_torch.train.state import count_params

    with apply_runtime_flags(args) as device:
        model = build_model("ESMStereo", build_config(args), device=device,
                            seed=args.seed)
        if args.performance:
            print("The number of parameters:", count_params(model))
            print("inference time = ", measure_performance(model))
            return 0

        train_ds = SceneFlowDataset(args.datapath, args.trainlist,
                                    training=True, crop=parse_hw(args.crop))
        test_ds = SceneFlowDataset(args.datapath, args.testlist,
                                   training=False,
                                   eval_crop=parse_hw(args.eval_crop))
        train_loader = DataLoader(train_ds, args.batch_size,
                                  num_workers=args.num_workers,
                                  drop_last=True,
                                  use_processes=bool(args.worker_processes),
                                  seed=args.seed)
        test_loader = DataLoader(test_ds, args.test_batch_size,
                                 num_workers=args.num_workers,
                                 drop_last=False, seed=args.seed)
        loop_cfg = TrainLoopConfig(
            epochs=args.epochs, lr=args.lr, lrepochs=args.lrepochs,
            optimizer="adamw", logdir=args.logdir, resume=args.resume,
            loadckpt=args.loadckpt, save_freq=args.save_freq,
            summary_freq=args.summary_freq, select_metric="EPE",
            image_freq=args.image_freq,
            fix_cv16_loss=args.fix_cv16_loss, seed=args.seed)
        logger = summary_writer(args.logdir)
        try:
            result = run_training(model, loop_cfg, train_loader,
                                  test_loader, logger=logger)
        finally:
            if logger is not None:
                logger.close()
    print("best:", {k: result[k] for k in ("best_epoch", "best_metric")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
