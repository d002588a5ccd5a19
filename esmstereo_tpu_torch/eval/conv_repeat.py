"""The hourglass conv3d k3 p1 of one checkout on the card: each conv's
device time, whether it repeats bit for bit, kernel E's fp32 row, and
whether L-deploy's forward repeats under cuDNN's default and deterministic
algorithms; and kernels F's and H's deploy forms launch by launch.

    python3 -m esmstereo_tpu_torch.eval.conv_repeat [--reps 30] [--fh-only]

First, for each of L-deploy-all, M-norm-deploy-all and S-deploy-all
(``chip_smoke.SWITCHED_PATHS``), it times one call of kernel F's deploy
form (``fused_stems.stems`` on both eyes' unit-normal fp32 image at 544 x
992) and of kernel H's bf16 form at each of the hourglass's two up levels
(``fused_hourglass.up_pair`` on unit-normal bf16 src and skip at that
path's shapes, tanh GELU), each as device time in a CUDA graph, and splits
it by CUDA kernel: ``torch.profiler``'s device time of each kernel name
over 20 calls (F's two StemBlocks; H's transposed conv, 1x1x1 conv and
k3 conv, or its fused transposed + 1x1x1 conv and k3 conv), with cuDNN's
bf16 calls of the same function (``chip_smoke.py`` [3]'s yardsticks) on
the same inputs. ``--fh-only`` stops there.

Run from the root of a checkout, on a CUDA device. For every conv3d k3 p1
that kernels C and G launch at L, M and S on a 544 x 992 frame (C's
group_stem and agg, G's two convs a level, from the nets' own modules) it
prints the device time of one call of ``fused_hourglass.conv3d_bn_gelu``
(fp32) and ``conv3d_bn_gelu_bf16`` (bf16) on unit-normal inputs (20 calls
captured in a CUDA graph, replayed 5 times between CUDA events) and how
many of ``--reps`` further calls differ from the first by any bit. Then
``chip_smoke.check_volume_stem_agg`` at L (kernel E's fp32 row of [3]),
and L-deploy's forward (``chip_smoke.DEPLOY_PATHS``, tanh GELU, 128 x 256)
8 times with ``torch.backends.cudnn.deterministic`` off and on, and how
many runs differ from the first. It uses only what PR 9's tree has, so
copied into an earlier checkout it holds that tree's kernels to the same
inputs: run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo, ESMStereoConfig,
                                                  conv3d_shapes)
from esmstereo_tpu_torch.ops.kernels import _build, fused_stems
from esmstereo_tpu_torch.ops.kernels import fused_hourglass as fh
from esmstereo_tpu_torch.ops.kernels.activations import gelu

CONFIGS = {"L": ESMStereoConfig(), "M": ESMStereoConfig(cv_scale=8),
           "S": ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")}


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def convs(net) -> list:
    """(name, ci, co, (d, h, w), stride) of C's two convs and G's six."""
    d, (h, w) = net.num_bins, chip_smoke.desc_shape(net)[2:]
    out = [("group_stem", net.config.num_groups, 8, (d, h, w), 1),
           ("agg", 8, 8, (d, h, w), 1)]
    agg = net.aggregation_out
    for k in (1, 2, 3):
        for s in (2, 1):
            co, ci = getattr(agg, f"conv{k}_{2 - s}").conv.weight.shape[:2]
            out.append((f"conv{k}_{2 - s}", ci, co, (d, h, w), s))
            if s == 2:
                d, h, w = ((n - 1) // 2 + 1 for n in (d, h, w))
    return out


def launch_split(fn, calls: int = 20) -> list:
    """(device ms a call, launches a call, kernel name) of each CUDA kernel
    ``fn`` launches, from ``torch.profiler`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / calls / 1e3, e.count / calls, e.key))
    return sorted(rows, reverse=True)


def up_levels(net) -> list:
    """(conv names, src shape, skip shape) of the hourglass's two up levels
    at batch 1 on a 544 x 992 frame, from ``conv3d_shapes``'s down levels
    (as ``chip_smoke.check_up_pairs_bf16`` takes them)."""
    downs = [(1, co, *((n - 1) // 2 + 1 for n in (d, h, w)))
             for name, ci, co, d, h, w, s
             in conv3d_shapes(net.config, *chip_smoke.PADDED) if s == 2]
    return [(("conv3_up", "agg_0_0", "agg_0_1"), downs[2], downs[1]),
            (("conv2_up", "agg_1_0", "agg_1_1"), downs[1], downs[0])]


def report(what: str, fn, library) -> None:
    print(f"{what}: {graph_ms(fn):.4f} ms a call (cuDNN bf16 "
          f"{graph_ms(library):.4f})", flush=True)
    for ms, n, name in launch_split(fn):
        print(f"    {ms:.4f} ms  x{n:g}  {name[:120]}", flush=True)


def stems_and_up_pairs(gen) -> None:
    """Kernel F's deploy form and kernel H's bf16 form on each switched
    deploy path, launch by launch (see the module's docstring)."""
    f = torch.nn.functional
    bf16 = torch.bfloat16
    for path, config in chip_smoke.SWITCHED_PATHS.items():
        net = ESMStereo(config, device="cuda", seed=chip_smoke.SEED)
        with torch.inference_mode():
            img = torch.randn((2, 3, *chip_smoke.PADDED),
                              generator=gen).cuda()
            low = fused_stems.prepare_consts(net.stem_2, net.stem_4,
                                             low_precision=True)
            fp = fused_stems.prepare_consts(net.stem_2, net.stem_4)
            lw = {k: v.permute(3, 0, 1, 2).contiguous().to(bf16)
                  for k, v in fp.items() if v.ndim == 4}
            lt = {k: v.to(bf16) for k, v in fp.items() if v.ndim == 1}
            ib = img.to(bf16)

            def stems_library():
                x = ib
                for s in "24":
                    x = gelu(f.conv2d(x, lw[f"wd{s}"], lt[f"td{s}"],
                                      stride=2, padding=1), True)
                    x = f.relu(f.conv2d(x, lw[f"wc{s}"], lt[f"tc{s}"],
                                        padding=1))
                return x

            report(f"F {path} stems {tuple(img.shape)}",
                   lambda: fused_stems.stems(img, low, True), stems_library)
            agg = net.aggregation_out
            for names, src_shape, skip_shape in up_levels(net):
                mods = [getattr(agg, n) for n in names]
                low = fh.prepare_up_consts(*mods, low_precision=True)
                lib = {k: v.to(bf16)
                       for k, v in fh.prepare_up_consts(*mods).items()}
                src = torch.randn(src_shape, generator=gen).cuda().to(bf16)
                skip = torch.randn(skip_shape, generator=gen).cuda().to(bf16)
                d2, h2, w2 = skip_shape[2:]

                def up_library(s=src, k_=skip, c=lib):
                    up = f.conv_transpose3d(s, c["wu"], c["tu"], stride=2,
                                            padding=1)[:, :, :d2, :h2, :w2]
                    z = f.conv3d(torch.cat([up, k_], dim=1), c["wc"],
                                 c["tc"])
                    return f.conv3d(z, c["w3"], c["t3"], padding=1)

                report(f"H {path} up_pair src {src_shape} skip {skip_shape}",
                       lambda s=src, k_=skip, c=low: fh.up_pair(s, k_, c,
                                                                True),
                       up_library)


def repeats(fn, reps: int) -> int:
    first = fn()
    return sum(not torch.equal(fn(), first) for _ in range(reps))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--fh-only", action="store_true",
                    help="time kernels F and H launch by launch, and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_repeat: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    gen = torch.Generator().manual_seed(7)
    with chip_smoke.tanh_gelu():
        stems_and_up_pairs(gen)
    if args.fh_only:
        return
    bf16 = torch.bfloat16
    with torch.inference_mode():
        for var, config in CONFIGS.items():
            net = ESMStereo(config, device="meta")
            for name, ci, co, dhw, s in convs(net):
                x = torch.randn((1, ci, *dhw), generator=gen).cuda()
                wt = (torch.randn((co, ci, 3, 3, 3), generator=gen)
                      / (27 * ci) ** 0.5).cuda()
                scale = torch.rand(co, generator=gen).cuda() + 0.5
                shift = 0.1 * torch.randn(co, generator=gen).cuda()
                xb, wb = x.to(bf16), wt.to(bf16)
                for form, fn in (
                        ("fp32", lambda: fh.conv3d_bn_gelu(x, wt, shift, s,
                                                           False)),
                        ("bf16", lambda: fh.conv3d_bn_gelu_bf16(
                            xb, wb, scale, shift, bf16, True, s))):
                    print(f"{var} {name} {ci} -> {co} {dhw} s{s} {form}: "
                          f"{graph_ms(fn):.4f} ms, "
                          f"{repeats(fn, args.reps)} of {args.reps} repeats "
                          f"differ", flush=True)
    with torch.no_grad():
        model = ESMStereo(ESMStereoConfig(), device="cuda",
                          seed=chip_smoke.SEED)
        row = chip_smoke.check_volume_stem_agg(model, gen, "fused")
    print(f"E fp32 L row: {row['ms']:.4f} ms", flush=True)
    net = ESMStereo(chip_smoke.DEPLOY_PATHS["L-deploy"], device="cuda",
                    seed=chip_smoke.SEED + 2)
    left = torch.randn((1, 128, 256, 3), generator=gen).cuda()
    right = torch.randn((1, 128, 256, 3), generator=gen).cuda()
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        with torch.inference_mode(), chip_smoke.tanh_gelu():
            runs = [net(left, right, capture_internals=True)[1]["cost"]
                    for _ in range(8)]
        differ = sum(not torch.equal(r, runs[0]) for r in runs[1:])
        print(f"L-deploy cost, cudnn.deterministic={deterministic}: "
              f"{differ} of 7 repeats differ", flush=True)
    torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
