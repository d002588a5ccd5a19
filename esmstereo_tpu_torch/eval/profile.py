"""Where a frame's device time goes: ESMStereo eval, batch 1, at 544x992
(a SceneFlow frame padded), or 384x1248 (a KITTI frame padded) for the
confidence model.

    python -m esmstereo_tpu_torch.eval.profile [--frames 10] [--top 25]
        [--cv-scale {4,8,16}] [--cost-volume {gwc,norm_correlation}]
        [--confidence] [--fuse-volume-agg] [--fuse-hourglass]
        [--fuse-hourglass-up] [--fuse-stems] [--fuse-mixer]
        [--dtype {float32,bfloat16}] [--fast-gelu] [--volume-int8]
        [--bf16-per-op]

Builds the model (L at ``--cv-scale 4``, the default; M at 8; S at 16,
which implies mobilenetv2_100; ``--confidence`` builds the confidence
model on S) with the chosen cost volume and seeded weights on the card,
prints the kernel launches of one frame (the CUDA kernels the profiler
saw and the port's wrapper calls), runs ``--frames``
forward passes on device-resident inputs under ``torch.profiler``, and
prints the device time per frame by kernel name (sorted, with shares), the
device busy share of the window, and the frame time from CUDA events
without the profiler. TF32 is off, as in ``chip_smoke.py`` and
``InferenceRunner``; the script prints the precision it ran at. Needs a
CUDA device; the kernels build on first use.

The deploy numerics of ``bench.py``: ``--dtype bfloat16 --fast-gelu``
(bf16 compute, tanh GELU), and ``--volume-int8`` for the int8 volume, at
every ``--cv-scale`` and ``--cost-volume``, with ``--confidence`` and with
any ``--fuse-*`` switches (their kernels then run their bf16 forms).
``--fast-gelu`` sets the package's GELU switch, a process global, for the
run; ``--bf16-per-op`` sets ``nn.blocks.set_bf16_per_op`` (the bf16
activations per op, as the JAX reference rounds them, one launch of the
``activations_bf16`` kernel each) the same way.

The switches select the configuration's opt-in kernel paths, as
``bench.py``'s ``BENCH_FUSE_VOLUME_AGG``, ``BENCH_FUSE_HOURGLASS`` and
``BENCH_FUSE_MIXER`` do for the JAX model:

  --fuse-volume-agg     the volume built inside group_stem (kernel E in
                        place of B + C)
  --fuse-hourglass      each hourglass down level as kernel G
  --fuse-hourglass-up   each hourglass up level as kernel H
  --fuse-stems          stem_2 + stem_4 as kernel F
  --fuse-mixer          the upsampler's ShuffleMixer section as kernel I

All five together are the configuration that runs every kernel the model
can reach (A, E, F, G, H and I at cv4; no I at cv8, where ``fuse_mixer``
reaches nothing, as in JAX; at cv16 A, B, C, F, G and H: neither
``fuse_volume_agg`` nor ``fuse_mixer`` reaches anything there).
"""

from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from esmstereo_tpu_torch.eval.runner import fp32_precision, precision
from esmstereo_tpu_torch.models.confidence import ESMStereoConfidence
from esmstereo_tpu_torch.models.esmstereo import ESMStereo, ESMStereoConfig
from esmstereo_tpu_torch.nn import blocks
from esmstereo_tpu_torch.ops.kernels import reset_launches, wrappers

PADDED = (544, 992)     # a SceneFlow 540x960 frame padded to the next /32
KITTI_PADDED = (384, 1248)   # a KITTI 375x1242 frame padded to the next /32


def frame_ms(model, left, right, frames: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        model(left, right)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--cv-scale", type=int, choices=(4, 8, 16), default=4,
                    help="4: ESMStereo-L, 8: ESMStereo-M, 16: ESMStereo-S "
                         "(mobilenetv2_100)")
    ap.add_argument("--cost-volume", choices=("gwc", "norm_correlation"),
                    default="gwc")
    ap.add_argument("--confidence", action="store_true",
                    help="the confidence model on ESMStereo-S (implies "
                         "--cv-scale 16) at a padded KITTI frame, 384x1248")
    ap.add_argument("--fuse-volume-agg", action="store_true",
                    help="kernel E in place of kernels B + C")
    ap.add_argument("--fuse-hourglass", action="store_true",
                    help="the hourglass down levels as kernel G")
    ap.add_argument("--fuse-hourglass-up", action="store_true",
                    help="the hourglass up levels as kernel H")
    ap.add_argument("--fuse-stems", action="store_true",
                    help="stem_2 + stem_4 as kernel F")
    ap.add_argument("--fuse-mixer", action="store_true",
                    help="the upsampler's ShuffleMixer section as kernel I")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="compute dtype; bfloat16 is the deploy numerics "
                         "(any variant, volume and --fuse-* switches)")
    ap.add_argument("--fast-gelu", action="store_true",
                    help="tanh GELU (the package's global switch)")
    ap.add_argument("--volume-int8", action="store_true",
                    help="the volume stored as int8 between kernels B "
                         "and C")
    ap.add_argument("--bf16-per-op", action="store_true",
                    help="the bf16 activations per op (the package's "
                         "global switch)")
    args = ap.parse_args()
    cv_scale = 16 if args.confidence else args.cv_scale
    config = ESMStereoConfig(cv_scale=cv_scale,
                             backbone=("mobilenetv2_100" if cv_scale == 16
                                       else "efficientnet_b2"),
                             cost_volume=args.cost_volume,
                             fuse_volume_agg=args.fuse_volume_agg,
                             fuse_hourglass=args.fuse_hourglass,
                             fuse_hourglass_up=args.fuse_hourglass_up,
                             fuse_stems=args.fuse_stems,
                             fuse_mixer=args.fuse_mixer, dtype=args.dtype,
                             volume_int8=args.volume_int8)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    gelu_before, per_op_before = blocks.GELU_APPROXIMATE, blocks.BF16_PER_OP
    blocks.set_gelu_approximate(args.fast_gelu)
    blocks.set_bf16_per_op(args.bf16_per_op)
    try:
        with fp32_precision():
            run(args, config)
    finally:
        blocks.set_gelu_approximate(gelu_before)
        blocks.set_bf16_per_op(per_op_before)


def run(args, config: ESMStereoConfig) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())

    print(f"config: {config}, confidence model: {args.confidence}")
    cls = ESMStereoConfidence if args.confidence else ESMStereo
    model = cls(config, device="cuda", seed=0)
    print(f"precision: {precision(model)}")
    gen = torch.Generator().manual_seed(0)
    shape = (1, *(KITTI_PADDED if args.confidence else PADDED), 3)
    print(f"input: {shape}")
    left = torch.randn(shape, generator=gen).cuda()
    right = torch.randn(shape, generator=gen).cuda()
    kernels = wrappers()
    with torch.inference_mode():
        frame_ms(model, left, right, 3)                    # build + warm up
        reset_launches()
        frame_ms(model, left, right, 1)
        launched = {k: dict(fn.form_launches) for k, fn in kernels.items()
                    if fn.launches}
        wall = frame_ms(model, left, right, args.frames)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window = frame_ms(model, left, right, args.frames)

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / args.frames / 1e3, e.count // args.frames,
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"per frame: {sum(r[1] for r in rows)} CUDA kernel launches "
          f"(profiler calls); the port's wrapper calls: {launched}")
    print(f"frame: {wall:.3f} ms (CUDA events, no profiler); "
          f"{window:.3f} ms under the profiler; device busy {busy:.3f} ms "
          f"per frame ({busy / window:.1%} of the window)")
    print(f"{'ms/frame':>9} {'share':>6} {'calls':>5}  kernel")
    for ms, calls, name in rows[:args.top]:
        print(f"{ms:9.4f} {ms / busy:6.1%} {calls:5d}  {name[:110]}")
    rest = rows[args.top:]
    if rest:
        print(f"{sum(r[0] for r in rest):9.4f} "
              f"{sum(r[0] for r in rest) / busy:6.1%}        "
              f"{len(rest)} other kernels")


if __name__ == "__main__":
    main()
