"""Shared plumbing of the command-line entry points.

The port's counterpart of ``tools/common.py``: the model flags onto the
port's ``ESMStereoConfig``, the runtime flags, and the device. Every CLI
runs on the card unless ``--cpu`` is given, and raises when there is no
card and no ``--cpu``.
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from esmstereo_tpu_torch.device import resolve_device
from esmstereo_tpu_torch.nn import blocks


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="ESMStereo",
                        choices=["ESMStereo", "ESMStereo_trt",
                                 "ESMStereo_confidence"],
                        help="accepted as the JAX CLIs accept it; like "
                             "them, every CLI builds ESMStereo")
    parser.add_argument("--backbone", default="efficientnet_b2",
                        choices=["mobilenetv2_100", "efficientnet_b2"])
    parser.add_argument("--maxdisp", type=int, default=192)
    parser.add_argument("--cv_scale", type=int, default=4,
                        choices=[16, 8, 4],
                        help="cost volume scale factor (L/M/S = 4/8/16)")
    parser.add_argument("--cv", type=str, default="gwc",
                        choices=["norm_correlation", "gwc"])
    parser.add_argument("--pallas", action="store_true",
                        help="changes nothing here: the eval volume always "
                             "runs the port's CUDA volume kernel")
    parser.add_argument("--no_pallas", action="store_true",
                        help="changes nothing here (see --pallas)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (parameters stay float32); "
                             "disparity regression and the disparity "
                             "stream run in float32")


def build_config(args):
    """The flags of ``add_model_args`` as an ``ESMStereoConfig``."""
    from esmstereo_tpu_torch.models.esmstereo import ESMStereoConfig
    return ESMStereoConfig(max_disp=args.maxdisp, cost_volume=args.cv,
                           backbone=args.backbone, cv_scale=args.cv_scale,
                           dtype=args.dtype)


def add_runtime_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly: fail fast "
                             "on NaN/Inf in a backward pass")
    parser.add_argument("--fast_gelu", action="store_true",
                        help="tanh-approximate GELU (the deploy numerics)")


@contextlib.contextmanager
def apply_runtime_flags(args):
    """While open: the runtime flags a CLI has applied (process globals:
    anomaly detection, the GELU form), yielding its device, the CPU with
    ``--cpu`` and the card otherwise (raising when there is none). The
    globals are restored on exit, so a ``main`` called in process leaves
    none behind."""
    if getattr(args, "spatial_shards", 1) > 1:
        raise NotImplementedError(
            "--spatial_shards > 1 shards over several GPUs; the port runs "
            "on one")
    device = resolve_device("cpu" if getattr(args, "cpu", False) else None)
    saved = torch.is_anomaly_enabled(), blocks.GELU_APPROXIMATE
    try:
        if getattr(args, "debug_nans", False):
            torch.autograd.set_detect_anomaly(True)
        if getattr(args, "fast_gelu", False):
            blocks.set_gelu_approximate(True)
        yield device
    finally:
        torch.autograd.set_detect_anomaly(saved[0])
        blocks.set_gelu_approximate(saved[1])


def parse_hw(spec: str) -> tuple[int, int]:
    """``"H,W"`` -> (H, W)."""
    h, w = (int(v) for v in spec.split(","))
    return h, w


def summary_writer(logdir: str):
    """A tensorboardX writer on ``logdir`` where the package is installed,
    else None (the JAX CLIs log the same way)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)
