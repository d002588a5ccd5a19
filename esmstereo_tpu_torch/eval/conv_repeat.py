"""The hourglass conv3d k3 p1 of one checkout on the card: each conv's
device time, whether it repeats bit for bit, kernel E's fp32 row, and
whether L-deploy's forward repeats under cuDNN's default and deterministic
algorithms; kernels F's and H's deploy forms launch by launch; and kernels
A and I launch by launch; and kernels B and F's fp32 form launch by
launch.

    python3 -m esmstereo_tpu_torch.eval.conv_repeat [--reps 30] [--fh-only]
    python3 -m esmstereo_tpu_torch.eval.conv_repeat --ai-only [--reps 30]
    python3 -m esmstereo_tpu_torch.eval.conv_repeat --bf-only [--reps 30]

``--bf-only`` times one call of kernel B
(``correlation.correlation_volume``) in every form a served path builds,
on unit-normal (1, 64, H/v, W/v) descriptors (bf16 on the deploy paths):
gwc at L, M and S and at L's unpadded 544 x 960 (``bench.py``'s frame),
norm-correlation (G = 1) at M, S and C (C at 384 x 1248), each in fp32
and in bf16 (B's rounding); at M's shapes the forms no path builds
(gwc_norm in fp32 and bf16, D's rounding of the three bf16 forms); and
of kernel F's fp32 form
(``fused_stems.stems``, the nets' own StemBlocks) on both eyes'
unit-normal fp32 image at 544 x 992, at L's widths (32, 48) and S's
(16, 24). Each as ``--ai-only`` reports it (device time in a CUDA graph,
split by CUDA kernel, repeats that differ). It calls only the wrappers'
public functions, so copied into an older checkout it times that
checkout's kernels.

``--bf-plans`` (this checkout only) times kernel B in each of those
forms under the plan of each block shape the source has an instance of
(``correlation.BLOCKS``), ``corr_plan``'s starred, and kernel F's fp32 form with each StemBlock at each
tile the source has an instance of (``fused_stems.STEM_INSTANCES``),
device time a call in a CUDA graph and by launch.

``--ai-only`` times one call of kernel A (``fused_head.fused_stage0``, the
nets' own stage-0 weights) on both eyes' unit-normal fp32 image at L's
and S's 544 x 992 (efficientnet_b2's and mobilenetv2_100's forms) and at
C's 384 x 1248 (mobilenetv2_100), writing fp32 and bf16, and of kernel I
(``fused_mixer.mixer``) on a unit-normal (1, 32, 136, 248) spx map at L in
fp32 and bf16: device time in a CUDA graph, split by CUDA kernel as below,
and how many of ``--reps`` further calls differ from the first by any
bit. Then it stops. It calls only the wrappers' public functions
(``fused_stage0``, ``mixer`` and their ``prepare_consts``), which older
checkouts have too, so copied into one it times that checkout's kernels.

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


def head_and_mixer(gen, reps: int) -> None:
    """Kernels A and I launch by launch (``--ai-only``; see the module's
    docstring)."""
    from esmstereo_tpu_torch.backbones import fused as fused_backbone
    from esmstereo_tpu_torch.ops.kernels import fused_head, fused_mixer

    bf16 = torch.bfloat16
    cases = (("L", CONFIGS["L"], chip_smoke.PADDED),
             ("S", CONFIGS["S"], chip_smoke.PADDED),
             ("C", CONFIGS["S"], chip_smoke.KITTI_PADDED))
    with torch.inference_mode():
        for var, config, padded in cases:
            net = ESMStereo(config, device="cuda", seed=chip_smoke.SEED)
            consts = fused_backbone.prepare_consts(net.feature)
            img = torch.randn((2, 3, *padded), generator=gen).cuda()
            form = fused_head.kernel_form(consts)
            for out in (torch.float32, bf16):
                def fn(c=consts, o=out):
                    return fused_head.fused_stage0(img, c, o)

                ms = graph_ms(fn)
                print(f"A {var} {form} {tuple(img.shape)} -> {out}: "
                      f"{ms:.4f} ms a call, {repeats(fn, reps)} of {reps} "
                      f"repeats differ", flush=True)
                for t, n, name in launch_split(fn):
                    print(f"    {t:.4f} ms  x{n:g}  {name[:120]}", flush=True)
        net = ESMStereo(CONFIGS["L"], device="cuda", seed=chip_smoke.SEED)
        stage = net.upsample_module.stage2x
        x = torch.randn((1, 32, chip_smoke.PADDED[0] // 4,
                         chip_smoke.PADDED[1] // 4), generator=gen).cuda()
        for low in (False, True):
            consts = fused_mixer.prepare_consts(stage, low_precision=low)
            xi = x.to(bf16) if low else x

            def fn(c=consts, v=xi):
                return fused_mixer.mixer(v, c)

            ms = graph_ms(fn)
            print(f"I L {tuple(xi.shape)} {xi.dtype}: {ms:.4f} ms a call, "
                  f"{repeats(fn, reps)} of {reps} repeats differ", flush=True)
            for t, n, name in launch_split(fn):
                print(f"    {t:.4f} ms  x{n:g}  {name[:120]}", flush=True)


# (path, config, padded frame, G, normalize, dtype[, B's rounding]) of each
# form of kernels B and D that ``--bf-only`` times: every served one, then
# at M's shapes those no path builds (gwc_norm; D's bf16 rounding)
BF_VOLUMES = (
    ("L", "L", chip_smoke.PADDED, 32, False, torch.float32),
    ("L-deploy", "L", chip_smoke.PADDED, 32, False, torch.bfloat16),
    ("L 544x960", "L", (544, 960), 32, False, torch.float32),
    ("L-deploy 544x960", "L", (544, 960), 32, False, torch.bfloat16),
    ("M", "M", chip_smoke.PADDED, 32, False, torch.float32),
    ("M-deploy", "M", chip_smoke.PADDED, 32, False, torch.bfloat16),
    ("M-norm", "M", chip_smoke.PADDED, 1, True, torch.float32),
    ("M-norm-deploy", "M", chip_smoke.PADDED, 1, True, torch.bfloat16),
    ("S", "S", chip_smoke.PADDED, 32, False, torch.float32),
    ("S-deploy", "S", chip_smoke.PADDED, 32, False, torch.bfloat16),
    ("S-norm", "S", chip_smoke.PADDED, 1, True, torch.float32),
    ("S-norm-deploy", "S", chip_smoke.PADDED, 1, True, torch.bfloat16),
    ("C", "S", chip_smoke.KITTI_PADDED, 1, True, torch.float32),
    ("C-deploy", "S", chip_smoke.KITTI_PADDED, 1, True, torch.bfloat16),
    ("gwc_norm at M", "M", chip_smoke.PADDED, 32, True, torch.float32),
    ("gwc_norm bf16 at M", "M", chip_smoke.PADDED, 32, True, torch.bfloat16),
    ("D's gwc bf16 at M", "M", chip_smoke.PADDED, 32, False, torch.bfloat16,
     False),
    ("D's gwc_norm bf16 at M", "M", chip_smoke.PADDED, 32, True,
     torch.bfloat16, False),
    ("D's norm bf16 at M", "M", chip_smoke.PADDED, 1, True, torch.bfloat16,
     False))


def timed(what: str, fn, reps: int) -> None:
    """One call of ``fn``: device ms in a CUDA graph, the repeats that
    differ, and the split by CUDA kernel."""
    ms = graph_ms(fn)
    first = fn()
    differ = sum(any(not torch.equal(a, b) for a, b in zip(fn(), first))
                 for _ in range(reps))
    print(f"{what}: {ms:.4f} ms a call, {differ} of {reps} repeats "
          f"differ", flush=True)
    for t, n, name in launch_split(fn):
        print(f"    {t:.4f} ms  x{n:g}  {name[:120]}", flush=True)


def volumes_and_stems(gen, reps: int) -> None:
    """Kernel B in every served form and kernel F's fp32 form, launch by
    launch (``--bf-only``; see the module's docstring)."""
    from esmstereo_tpu_torch.ops.kernels import correlation

    with torch.inference_mode():
        for path, var, padded, g, norm, dtype, *rounding in BF_VOLUMES:
            net = ESMStereo(CONFIGS[var], device="meta")
            shape = chip_smoke.desc_shape(net, padded)
            ref = torch.randn(shape, generator=gen).cuda().to(dtype)
            tgt = torch.randn(shape, generator=gen).cuda().to(dtype)

            def fn(r=ref, t=tgt, d=net.num_bins, g=g, n=norm,
                   rnd=rounding[0] if rounding else True):
                return (correlation.correlation_volume(r, t, d, g, n, rnd),)

            form = ("norm" if g == 1 else "gwc_norm") if norm else "gwc"
            timed(f"B {path} {form} {tuple(shape)} D={net.num_bins} "
                  f"{dtype}", fn, reps)
        img = torch.randn((2, 3, *chip_smoke.PADDED), generator=gen).cuda()
        for var in ("L", "S"):
            net = ESMStereo(CONFIGS[var], device="cuda",
                            seed=chip_smoke.SEED)
            consts = fused_stems.prepare_consts(net.stem_2, net.stem_4)

            def fn(c=consts):
                return fused_stems.stems(img, c, False)

            timed(f"F fp32 {fused_stems.widths(consts)} "
                  f"{tuple(img.shape)}", fn, reps)


def volume_plans_and_stem_tiles(gen) -> None:
    """Kernel B under every plan and F's fp32 form at every tile
    (``--bf-plans``; see the module's docstring)."""
    from esmstereo_tpu_torch.ops.kernels import correlation

    with torch.inference_mode():
        for path, var, padded, g, norm, dtype, *_ in BF_VOLUMES:
            net = ESMStereo(CONFIGS[var], device="meta")
            b, c, h, w = chip_smoke.desc_shape(net, padded)
            ref = torch.randn((b, c, h, w), generator=gen).cuda().to(dtype)
            tgt = torch.randn((b, c, h, w), generator=gen).cuda().to(dtype)
            d = net.num_bins
            es = ref.element_size()
            chosen = correlation.corr_plan(b, c, g, h, w, d, norm, es)
            times = []
            for blk in correlation.BLOCKS:
                plan = correlation.make_plan(b, c, g, h, w, d, norm, *blk, es)
                ms = graph_ms(lambda p=plan: correlation.volume_kernel(
                    ref, tgt, d, g, norm, True, p))
                times.append(f"{plan.columns}x{plan.rows}"
                             f"{'*' if plan == chosen else ''} {ms:.4f}")
            print(f"B {path} {(b, c, h, w)} D={d}, columns x rows ms: "
                  + ", ".join(times), flush=True)
        img = torch.randn((2, 3, *chip_smoke.PADDED), generator=gen).cuda()
        for var in ("L", "S"):
            net = ESMStereo(CONFIGS[var], device="cuda",
                            seed=chip_smoke.SEED)
            consts = fused_stems.prepare_consts(net.stem_2, net.stem_4)
            c2, c4 = fused_stems.widths(consts)
            for key in (("fp32", 3, c2), ("fp32", c2, c4)):
                tiles = sorted(i[3:] for i in fused_stems.STEM_INSTANCES
                               if i[:3] == key)
                kept = fused_stems.STEM_TILES[key]
                for tile in tiles:
                    fused_stems.STEM_TILES[key] = tile
                    fused_stems._plan_ints.cache_clear()
                    fn = lambda c=consts: fused_stems.stems(  # noqa: E731
                        img, c, False)
                    print(f"F {key} tile {tile}{'*' if tile == kept else ''}"
                          f": {graph_ms(fn):.4f} ms a call", flush=True)
                    for t, n, name in launch_split(fn):
                        print(f"    {t:.4f} ms  x{n:g}  {name[:100]}",
                              flush=True)
                fused_stems.STEM_TILES[key] = kept
                fused_stems._plan_ints.cache_clear()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--fh-only", action="store_true",
                    help="time kernels F and H launch by launch, and stop")
    ap.add_argument("--ai-only", action="store_true",
                    help="time kernels A and I launch by launch, and stop")
    ap.add_argument("--bf-only", action="store_true",
                    help="time kernel B's served forms and F's fp32 form "
                         "launch by launch, and stop")
    ap.add_argument("--bf-plans", action="store_true",
                    help="time kernel B under every plan and F's fp32 form "
                         "at every tile, and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_repeat: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    gen = torch.Generator().manual_seed(7)
    if args.ai_only:
        head_and_mixer(gen, args.reps)
        return
    if args.bf_only:
        volumes_and_stems(gen, args.reps)
        return
    if args.bf_plans:
        volume_plans_and_stem_tiles(gen)
        return
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
