"""Kernel E's fp32 row at L in one checkout: the time of
``fused_agg_stem.volume_stem_agg`` on (1, 64, 136, 248) descriptors, 48
bins, 32 groups, ESMStereo-L's group_stem and agg weights (seed 0).

    python3 -m esmstereo_tpu_torch.eval.volume_rows [--rounds 5]

Run from the root of a checkout, on a CUDA device (the kernels it calls
build at first use). It prints, ``--rounds`` times, the wall time a call
of 20 back-to-back calls between CUDA events (``chip_smoke.py`` [3]'s
``cuda_ms``), and the device time a call in a CUDA graph of 20 calls. It uses only what every checkout since kernel E
was ported has (the model's ``volume_stem``, or ``group_stem`` before M
was ported; ``prepare_consts``; ``volume_stem_agg`` without its later
arguments), so copied into an unpacked older tree it holds that tree's
kernel to the same inputs: run the trees in turns in one call.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from esmstereo_tpu_torch.models.esmstereo import ESMStereo
from esmstereo_tpu_torch.ops.kernels import fused_agg_stem


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20) -> float:
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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("volume_rows: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator().manual_seed(11)
    with torch.inference_mode():
        model = ESMStereo(device="cuda", seed=0)
        stem = getattr(model, "volume_stem", None) or model.group_stem
        consts = fused_agg_stem.prepare_consts(stem, model.agg)
        ref = torch.randn((1, 64, 136, 248), generator=gen).cuda()
        tgt = torch.randn((1, 64, 136, 248), generator=gen).cuda()

        def e():
            return fused_agg_stem.volume_stem_agg(ref, tgt, consts, 48, 32,
                                                  False)

        for r in range(args.rounds):
            print(f"E fp32 L round {r}: {events_ms(e):.4f} ms a call "
                  f"(events), {graph_ms(e):.4f} ms (device, graph)",
                  flush=True)


if __name__ == "__main__":
    main()
