"""The hourglass conv3d k3 p1 of one checkout on the card: each conv's
device time, whether it repeats bit for bit, kernel E's fp32 row, and
whether L-deploy's forward repeats under cuDNN's default and deterministic
algorithms.

    python3 -m esmstereo_tpu_torch.eval.conv_repeat [--reps 30]

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

import chip_smoke
from esmstereo_tpu_torch.models.esmstereo import ESMStereo, ESMStereoConfig
from esmstereo_tpu_torch.ops.kernels import _build
from esmstereo_tpu_torch.ops.kernels import fused_hourglass as fh

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


def repeats(fn, reps: int) -> int:
    first = fn()
    return sum(not torch.equal(fn(), first) for _ in range(reps))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_repeat: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    gen = torch.Generator().manual_seed(7)
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
