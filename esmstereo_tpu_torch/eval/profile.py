"""Where a frame's device time goes: ESMStereo-L eval at 544x992, batch 1.

    python -m esmstereo_tpu_torch.eval.profile [--frames 10] [--top 25]

Builds the L model with seeded weights on the card, runs ``--frames``
forward passes on device-resident inputs under ``torch.profiler``, and
prints the device time per frame by kernel name (sorted, with shares), the
device busy share of the window, and the frame time from CUDA events
without the profiler. TF32 is off, as in ``chip_smoke.py``. Needs a CUDA
device; the kernels build on first use.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from esmstereo_tpu_torch.models.esmstereo import ESMStereo

PADDED = (544, 992)     # a SceneFlow 540x960 frame padded to the next /32


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())

    model = ESMStereo(device="cuda", seed=0)
    gen = torch.Generator().manual_seed(0)
    shape = (1, *PADDED, 3)
    left = torch.randn(shape, generator=gen).cuda()
    right = torch.randn(shape, generator=gen).cuda()
    with torch.inference_mode():
        frame_ms(model, left, right, 3)                    # build + warm up
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
