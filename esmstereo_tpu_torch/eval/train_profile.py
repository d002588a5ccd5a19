"""Where a training step's device time goes: ESMStereo, fp32, TF32 off, on
the SceneFlow recipe's batch (4 synthetic scenes of 256x512 by default).

    python -m esmstereo_tpu_torch.eval.train_profile [--steps 5] [--top 20]
        [--cv-scale {4,8,16}] [--batch 4] [--crop 256 512]

Builds the model (L at ``--cv-scale 4``, the default; M at 8; S at 16,
with mobilenetv2_100) with seeded weights on the card, an AdamW train
state at lr 1e-3 and one batch of ``data.synthetic.make_scene_batch``
already on the card, and runs ``train.step.make_train_step``'s step: 2
warm-up steps, then ``--steps`` steps timed by CUDA events in three parts
(forward and loss; backward; optimizer and schedule), then ``--steps``
steps under ``torch.profiler``: the device busy time a step and its share
of the window, the CUDA kernel launches a step, the port's kernel-wrapper
launches (0: the training forward takes the plain modules), the peak
device memory, the device time a step by kernel name, and the convolution
backward calls with the most device time, by input shapes. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from esmstereo_tpu_torch.data.synthetic import make_scene_batch
from esmstereo_tpu_torch.models.esmstereo import ESMStereo, ESMStereoConfig
from esmstereo_tpu_torch.models.losses import disparity_masks, model_loss_train
from esmstereo_tpu_torch.ops.kernels import reset_launches, wrappers
from esmstereo_tpu_torch.train.state import create_train_state
from esmstereo_tpu_torch.train.step import batch_to_device, make_train_step


def timed_parts(model, state, batch: dict, steps: int) -> list:
    """(forward + loss, backward, optimizer) device ms of each of ``steps``
    steps, by CUDA events between the parts of ``make_train_step``'s
    step."""
    cfg = model.config
    gts = [batch["disparity"], *batch["disparity_low"]]
    masks = disparity_masks(gts, cfg.max_disp)
    params = list(model.parameters())
    model.train()
    out = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        outs = model(batch["left"], batch["right"])
        loss = model_loss_train(outs, gts, masks, cfg.cv_scale)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ev[2].record()
        state.optimizer.step()
        state.scheduler.step()
        ev[3].record()
        torch.cuda.synchronize()
        out.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--cv-scale", type=int, default=4, choices=(4, 8, 16))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--crop", type=int, nargs=2, default=(256, 512))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    config = (ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")
              if args.cv_scale == 16 else
              ESMStereoConfig(cv_scale=args.cv_scale))
    print(f"config: {config}; fp32, TF32 off; batch {args.batch} x "
          f"{args.crop[0]}x{args.crop[1]}")
    model = ESMStereo(config, device="cuda", seed=0)
    state = create_train_state(model, "adamw", lambda step: 1e-3)
    batch = batch_to_device(make_scene_batch(
        np.random.default_rng(0), args.batch, *args.crop), "cuda")
    step = make_train_step(model)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    parts = np.asarray(timed_parts(model, state, batch, args.steps))
    peak = torch.cuda.max_memory_allocated()
    med = np.median(parts, axis=0)
    print(f"step parts (CUDA events, median of {args.steps}): forward + loss "
          f"{med[0]:.3f} ms, backward {med[1]:.3f} ms, optimizer "
          f"{med[2]:.3f} ms; sum {med.sum():.3f} ms (each step: "
          f"{', '.join(f'{p.sum():.2f}' for p in parts)} ms)")
    print(f"peak device memory {peak / 2**30:.3f} GiB; the port's kernel "
          f"launches in {args.steps} steps: "
          f"{sum(fn.launches for fn in wrappers().values())}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        for _ in range(args.steps):
            step(state, batch)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / args.steps
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / args.steps / 1e3, e.count // args.steps,
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"per step under the profiler: {window:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / window:.1%}), "
          f"{sum(r[1] for r in rows)} CUDA kernel launches")
    print(f"{'ms/step':>9} {'share':>6} {'calls':>5}  kernel")
    for ms, calls, name in rows[:args.top]:
        print(f"{ms:9.4f} {ms / busy:6.1%} {calls:5d}  {name[:110]}")
    rest = rows[args.top:]
    if rest:
        print(f"{sum(r[0] for r in rest):9.4f} "
              f"{sum(r[0] for r in rest) / busy:6.1%}        "
              f"{len(rest)} other kernels")
    convs = sorted(
        ((getattr(e, "device_time_total", None) or e.cuda_time_total)
         / args.steps / 1e3, e.count // args.steps, e.input_shapes)
        for e in prof.key_averages(group_by_input_shape=True)
        if e.key == "aten::convolution_backward")[::-1]
    print("convolution backward by input shapes (grad_out, input, weight):")
    for ms, calls, shapes in convs[:args.top // 2]:
        print(f"{ms:9.4f} ms {calls:3d} calls  {shapes[:3]}")


if __name__ == "__main__":
    main()
