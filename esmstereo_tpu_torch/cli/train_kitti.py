"""KITTI 2012 + 2015 finetuning.

The port's counterpart of ``tools/train_kitti.py`` (the reference's
``train_kitti.py``): Adam lr 1e-3, 600 epochs capped at ``--max_batches``
(100) batches each, LR/10 at epoch 300, warm start from the SceneFlow
checkpoint (``--loadckpt``), model selection on D1, over
``train.loop.run_training``. The eval pads each image to ``--pad_to``
(384x1248).

    python -m esmstereo_tpu_torch.cli.train_kitti --datapath_12 KITTI2012 \\
        --datapath_15 KITTI2015 --trainlist filenames/kitti12_15_all.txt \\
        --testlist filenames/kitti15_val.txt \\
        --loadckpt logs/sceneflow/checkpoint_000059 --logdir logs/kitti
"""

from __future__ import annotations

import argparse
import sys

from esmstereo_tpu_torch.cli.common import (add_model_args, add_runtime_args,
                                            apply_runtime_flags, build_config,
                                            parse_hw, summary_writer)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ESMStereo KITTI finetune "
                                            "(PyTorch port)")
    add_model_args(p)
    p.add_argument("--datapath_12", default="/datasets/kitti_2012/")
    p.add_argument("--datapath_15", default="/datasets/kitti_2015/")
    p.add_argument("--trainlist", default="./filenames/kitti12_15_all.txt")
    p.add_argument("--testlist", default="./filenames/kitti15_val.txt")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--test_batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--lrepochs", type=str, default="300:10")
    p.add_argument("--logdir", default="./logs/kitti")
    p.add_argument("--loadckpt", default="",
                   help="SceneFlow checkpoint to warm-start from")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=1)
    p.add_argument("--image_freq", type=int, default=0,
                   help="TB image dumps every N steps (0=off)")
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--worker_processes", type=int, default=1,
                   help="1: forked loader workers (threads serialize on the "
                        "interpreter lock); 0: threads")
    p.add_argument("--max_batches", type=int, default=100,
                   help="batches per epoch cap (train_kitti.py:116-117)")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="H-sharding over several GPUs: 1 only (the port "
                        "runs on one)")
    p.add_argument("--fix_cv16_loss", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--crop", default="256,512",
                   help="training crop H,W")
    p.add_argument("--pad_to", default="384,1248",
                   help="eval zero-pad target H,W (reference 384,1248)")
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from esmstereo_tpu_torch.data.datasets import KITTIDataset
    from esmstereo_tpu_torch.data.loader import DataLoader
    from esmstereo_tpu_torch.models import build_model
    from esmstereo_tpu_torch.train.loop import TrainLoopConfig, run_training

    with apply_runtime_flags(args) as device:
        model = build_model("ESMStereo", build_config(args), device=device,
                            seed=args.seed)
        train_ds = KITTIDataset(args.datapath_12, args.datapath_15,
                                args.trainlist, training=True,
                                crop=parse_hw(args.crop))
        test_ds = KITTIDataset(args.datapath_12, args.datapath_15,
                               args.testlist, training=False,
                               pad_to=parse_hw(args.pad_to))
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
            optimizer="adam", logdir=args.logdir, resume=args.resume,
            loadckpt=args.loadckpt, save_freq=args.save_freq,
            summary_freq=args.summary_freq, image_freq=args.image_freq,
            max_batches_per_epoch=args.max_batches, select_metric="D1",
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
