"""The hourglass conv3d k3 p1 (``csrc/fused_hourglass.cu``) on the card:
its launch plans against every other tile and split, and against cuDNN.

    python3 -m esmstereo_tpu_torch.eval.conv_sweep

Run from the root of a checkout, on a CUDA device. It times every conv
shape that kernels C, E's agg, G and H launch at L, M, M-norm and S on a
544 x 992 frame (``models/esmstereo.py::conv3d_shapes``) in both forms
(fp32, bf16 -> bf16) under each tile and cluster size the kernels take,
and one cuDNN ``conv3d`` with the bias on the same inputs (bf16 operands
for the deploy form, TF32 off), as device time: 20 launches captured in a
CUDA graph, replayed 5 times between CUDA events, so the host's launch
cost is not read. It prints, per conv and form, ``conv_plan``'s choice,
the fastest and cuDNN; then per variant and form the sums over C's two
convs and over G's six, and over every distinct conv.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools

import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.models.esmstereo import (ESMStereoConfig,
                                                  conv3d_shapes)
from esmstereo_tpu_torch.ops.kernels import fused_hourglass as fh

FRAME = (544, 992)          # a 540 x 960 frame padded to the next /32
CONFIGS = {"L": ESMStereoConfig(), "M": ESMStereoConfig(cv_scale=8),
           "M-norm": ESMStereoConfig(cv_scale=8,
                                     cost_volume="norm_correlation"),
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


def variants(form: str, ci: int, co: int, stride: int):
    """((rows, depths), cluster) of every launch the kernels take for a
    conv: each of its tiles with each split of its channels (powers of two
    in fp32, as ``conv_plan`` splits them)."""
    units = -(-ci // fh.conv_plan(form, ci, co, 1, 1, 1, stride).k_chunk)
    splits = ((1, 2, 4, 8) if form == "fp32"
              else range(1, fh.MAX_CLUSTER + 1))
    for tile, r in itertools.product(fh.conv_tiles(form, ci, co, stride),
                                     splits):
        if r <= min(fh.MAX_CLUSTER, units):
            yield tile, r


def time_conv(name: str, ci: int, co: int, d: int, h: int, w: int, s: int,
              form: str, gen) -> dict:
    """Device ms of the conv under its plan, under its fastest tile and
    split, and of cuDNN; the plan's and the fastest's keys."""
    dtype = torch.float32 if form == "fp32" else torch.bfloat16
    x = torch.randn((1, ci, d, h, w), generator=gen).cuda().to(dtype)
    wt = (torch.randn((co, ci, 3, 3, 3), generator=gen)
          / (27 * ci) ** 0.5).cuda().to(dtype)
    shift = torch.zeros(co, device="cuda")
    scale = torch.ones(co, device="cuda")
    out = [(n - 1) // s + 1 for n in (d, h, w)]
    y = torch.empty((1, co, *out), device="cuda", dtype=dtype)
    fn = fh._fns()[0 if form == "fp32" else 3]
    weights = ((wt.data_ptr(),) if form == "fp32" else
               (wt.data_ptr(), scale.data_ptr()))
    times = {}
    for tile, r in variants(form, ci, co, s):
        ints = fh.conv_layout(form, ci, co, d, h, w, s, tile,
                              r).ints(1, False)
        args = (x.data_ptr(), *weights, shift.data_ptr(), y.data_ptr(),
                ctypes.addressof(ints))

        def launch(args=args):
            # on the current stream, the capturing one in a graph
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name} {form}: CUDA error {err}")

        times[f"{tile[0]}x{tile[1]} R{r}"] = graph_ms(launch)
    bias = shift.to(dtype)
    cudnn = graph_ms(lambda: F.conv3d(x, wt, bias, stride=s, padding=1))
    plan = fh.conv_plan(form, ci, co, d, h, w, s)
    key = f"{plan.tile[1]}x{plan.tile[2]} R{plan.cluster}"
    best = min(times, key=times.get)
    return {"plan": times[key], "plan_key": key, "fastest": times[best],
            "fastest_key": best, "cudnn": cudnn}


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_sweep: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    seen = {}
    for var, config in CONFIGS.items():
        sums = {}
        for name, *shape in conv3d_shapes(config, *FRAME):
            kernel = "C" if "." not in name else "G"
            for form in ("fp32", "bf16"):
                key = (form, *shape)
                if key not in seen:
                    seen[key] = t = time_conv(name, *shape, form, gen)
                    print(f"{var:6s} {name:24s} {shape[0]:2d} -> "
                          f"{shape[1]:2d} s{shape[-1]} {form}: plan "
                          f"{t['plan_key']} {t['plan']:.4f} ms, fastest "
                          f"{t['fastest_key']} {t['fastest']:.4f} ms, cuDNN "
                          f"{t['cudnn']:.4f} ms", flush=True)
                acc = sums.setdefault((kernel, form), [0.0, 0.0, 0.0])
                for i, k in enumerate(("plan", "fastest", "cudnn")):
                    acc[i] += seen[key][k]
        for (kernel, form), (plan, fastest, cudnn) in sums.items():
            print(f"SUM {var} {kernel} {form}: plan {plan:.4f} ms, fastest "
                  f"{fastest:.4f} ms, cuDNN {cudnn:.4f} ms ({plan / cudnn:.2f}x)")
    for form in ("fp32", "bf16"):
        rows = [t for k, t in seen.items() if k[0] == form]
        plan, fastest, cudnn = (sum(t[k] for t in rows)
                                for k in ("plan", "fastest", "cudnn"))
        print(f"SUM every distinct conv {form}: plan {plan:.4f} ms, fastest "
              f"{fastest:.4f} ms, cuDNN {cudnn:.4f} ms")


if __name__ == "__main__":
    main()
