#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py            # from the root of the repository

Drives the port's main path, eval-mode ESMStereo-L (efficientnet_b2, cv4
group-wise correlation, 48 bins, fp32) with seeded random weights, and
holds each hand-written kernel against its plain PyTorch version:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build the three kernels from ``esmstereo_tpu_torch/csrc`` (one ``nvcc``
     per source, all at once) and print ``ptxas`` register/spill lines;
  3. each kernel and its plain version on the same inputs at the main-path
     shapes (a 540x960 SceneFlow frame padded to 544x992, both eyes):
     max abs / relative error against the stated tolerance, CUDA-event
     times, the bound from bytes and operations, and for kernel C the time
     of cuDNN's ``conv3d`` pair as a yardstick (the port never calls it);
     then each kernel again at small shapes with ragged tiles on every axis;
  4. the model on the card against the same weights on the CPU (plain
     versions) on a 128x256 pair;
  5. launch counters set to 0, then 3 requests served through
     ``InferenceRunner`` (uint8 540x960 pairs): shape, finiteness and time
     of each; every kernel must have launched on each request;
  6. a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``cudnn.allow_tf32 = False``, matmul precision
"highest"): the slice is fp32, and so are the plain versions it is held
against. Any failure raises; nothing is caught. Without a CUDA device the
script exits non-zero before it prints a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from esmstereo_tpu_torch.eval.runner import InferenceRunner
from esmstereo_tpu_torch.models.esmstereo import ESMStereo
from esmstereo_tpu_torch.ops.kernels import _build, wrappers
from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
from esmstereo_tpu_torch.ops.kernels import fused_head
from esmstereo_tpu_torch.backbones import fused as fused_backbone
from esmstereo_tpu_torch.nn import blocks

SEED = 0
FRAME = (540, 960)            # SceneFlow; the runner pads to 544 x 992
PADDED = (544, 992)
REQUESTS = 3
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 on the
# CUDA cores (no tensor cores: every kernel of this slice is fp32 FMA).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card in ms, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require(ok, what: str) -> None:
    """Fail the run (a check that ``python -O`` keeps, unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float) -> float:
    """Max abs error; fails unless it is within ``rtol * max(1, max|want|)``."""
    require(got.shape == want.shape,
            f"{name}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
    require(torch.isfinite(got).all(), f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    print(f"  {name}: max abs err {err:.3e}, relative {err / scale:.3e} "
          f"(tolerance {rtol:g} relative)")
    require(err <= rtol * scale,
            f"{name}: kernel disagrees with its plain version")
    return err


def check_fused_stage0(model, gen) -> dict:
    """Kernel A at the main path's shapes: both eyes, 544 x 992."""
    dev = torch.device("cuda")
    img = torch.randn((2, 3, *PADDED), generator=gen).to(dev)
    consts = fused_backbone.prepare_consts(model.feature)
    got = fused_head.fused_stage0(img, consts)
    want = fused_head.stage0_plain(img, consts)
    # fp32; the SE means sum 135k pixels in another order than torch's mean
    err = compare("fused_stage0", got, want, 1e-4)
    b, _, h, w = img.shape
    px = b * (h // 2) * (w // 2)
    c0, c1, c2 = 32, 16, 16
    macs = px * (c0 * 27 + c0 * 9 + c1 * c0 + c1 * 9 + c2 * c1)
    bms, by = bound(nbytes(img, consts["packed"], got), 2 * macs)
    return {"name": "fused_stage0", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_head.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_head.py:198",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_head.fused_stage0(img, consts)),
            "plain_ms": cuda_ms(lambda: fused_head.stage0_plain(img, consts)),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_gwc_volume(model, gen) -> tuple[dict, torch.Tensor]:
    """Kernel B at the main path's shapes: (1, 64, 136, 248) descriptors."""
    dev = torch.device("cuda")
    shape = (1, 64, PADDED[0] // 4, PADDED[1] // 4)
    ref = torch.randn(shape, generator=gen).to(dev)
    tgt = torch.randn(shape, generator=gen).to(dev)
    d, g = model.num_bins, model.config.num_groups
    got = correlation.gwc_volume(ref, tgt, d, g)
    want = correlation.gwc_volume_plain(ref, tgt, d, g)
    err = compare("gwc_volume", got, want, 1e-5)
    flops = got.numel() * (2 * (shape[1] // g) + 1)   # products, sum, 1/n
    bms, by = bound(nbytes(ref, tgt, got), flops)
    row = {"name": "gwc_volume", "route": "cuda",
           "source": "esmstereo_tpu_torch/csrc/correlation.cu",
           "replaces": "esmstereo_tpu/ops/pallas/correlation.py:132",
           "max_abs_err": err,
           "ms": cuda_ms(lambda: correlation.gwc_volume(ref, tgt, d, g)),
           "plain_ms": cuda_ms(
               lambda: correlation.gwc_volume_plain(ref, tgt, d, g)),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    return row, got


def check_stem_agg(model, volume: torch.Tensor) -> dict:
    """Kernel C on kernel B's volume, (1, 32, 48, 136, 248)."""
    consts = fused_agg_stem.prepare_consts(model.group_stem, model.agg)
    approx = blocks.GELU_APPROXIMATE
    got = fused_agg_stem.stem_agg(volume, consts, approx)
    want = fused_agg_stem.stem_agg_plain(volume, consts, approx)
    # fp32 sums of 864 and 216 products in another order than cuDNN's
    err = compare("stem_agg", got, want, 1e-4)
    vox = got.numel() // got.shape[1]
    ci, co = volume.shape[1], got.shape[1]
    flops = 2 * vox * 27 * (ci * co + co * co)
    bms, by = bound(nbytes(volume, consts["w1"], consts["t1"], consts["w2"],
                           consts["t2"], got), flops)

    def library():
        y = torch.nn.functional.conv3d(volume, consts["w1"], consts["t1"],
                                       padding=1)
        return torch.nn.functional.conv3d(y, consts["w2"], consts["t2"],
                                          padding=1)

    return {"name": "stem_agg", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_agg_stem.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_agg_stem.py:162",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_agg_stem.stem_agg(volume, consts,
                                                          approx)),
            "plain_ms": cuda_ms(lambda: fused_agg_stem.stem_agg_plain(
                volume, consts, approx)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)}


def check_ragged(model, gen) -> None:
    """Each kernel against its plain version at small shapes that leave
    ragged tiles on every axis the main path leaves whole (kernel A's rows,
    kernel C's depth and rows), with batch 2 for B and C."""
    dev = torch.device("cuda")
    img = torch.randn((1, 3, 2 * 37, 2 * 45), generator=gen).to(dev)
    consts = fused_backbone.prepare_consts(model.feature)
    compare("fused_stage0 (1, 3, 74, 90)", fused_head.fused_stage0(
        img, consts), fused_head.stage0_plain(img, consts), 1e-4)
    ref = torch.randn((2, 64, 5, 70), generator=gen).to(dev)
    tgt = torch.randn((2, 64, 5, 70), generator=gen).to(dev)
    compare("gwc_volume (2, 64, 5, 70), D=48",
            correlation.gwc_volume(ref, tgt, 48, 32),
            correlation.gwc_volume_plain(ref, tgt, 48, 32), 1e-5)
    vol = torch.randn((2, 32, 13, 7, 37), generator=gen).to(dev)
    consts = fused_agg_stem.prepare_consts(model.group_stem, model.agg)
    for approx in (False, True):
        compare(f"stem_agg (2, 32, 13, 7, 37), tanh GELU {approx}",
                fused_agg_stem.stem_agg(vol, consts, approx),
                fused_agg_stem.stem_agg_plain(vol, consts, approx), 1e-4)


def check_against_cpu(gen) -> None:
    """The model on the card (kernels) == the same weights on the CPU
    (plain versions) on a small pair. The hourglass output is sharpened
    (``conv1_up`` x 30) so that top-2 regression rarely meets a near-tie;
    the 1% exemption covers the pixels where it still does."""
    cpu = ESMStereo(device="cpu", seed=SEED + 1)
    with torch.no_grad():
        cpu.aggregation_out.conv1_up.conv.weight.mul_(30.0)
    gpu = ESMStereo(device="cuda", seed=SEED + 1)
    gpu.load_state_dict(cpu.state_dict())
    left = torch.randn((1, 128, 256, 3), generator=gen)
    right = torch.randn((1, 128, 256, 3), generator=gen)
    with torch.inference_mode():
        want, want_aux = cpu(left, right, capture_internals=True)
        got, got_aux = gpu(left.cuda(), right.cuda(), capture_internals=True)
    for key in ("match_left", "cost"):
        g, w = got_aux[key].cpu(), want_aux[key]
        rel = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        print(f"  {key}: relative max err {rel:.3e} (tolerance 1e-4)")
        require(rel < 1e-4, f"{key}: card disagrees with CPU")
    g, w = got[0].cpu(), want[0]
    require(g.shape == w.shape == (1, 128, 256) and torch.isfinite(g).all(),
            "disparity on the card: wrong shape or non-finite")
    rel = (g - w).abs() / max(1.0, float(w.abs().max()))
    frac = float((rel < 1e-4).float().mean())
    print(f"  disparity: {frac:.4%} of pixels within 1e-4 relative "
          f"(tolerance: at least 99%), max {float(rel.max()):.3e}")
    require(frac >= 0.99, "disparity: card disagrees with CPU")


def serve(model, rng: np.random.Generator) -> None:
    """Answer ``REQUESTS`` uint8 pairs; check and print each disparity."""
    runner = InferenceRunner(model)
    for i in range(REQUESTS):
        left = rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8)
        right = np.roll(left, -8, axis=1)          # a constant 8-px shift
        disp, dt = runner(left, right)
        require(disp.shape == FRAME, f"request {i}: disparity {disp.shape}")
        require(np.isfinite(disp).all(), f"request {i}: non-finite disparity")
        print(f"  request {i}: {FRAME[0]}x{FRAME[1]} -> disparity "
              f"{disp.shape}, {dt * 1e3:.2f} ms "
              f"(range {disp.min():.3f} .. {disp.max():.3f})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[2] built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        print(f"  {name}:\n    " + _build.ptxas_report(name).replace(
            "\n", "\n    "))

    gen = torch.Generator().manual_seed(SEED)
    model = ESMStereo(device="cuda", seed=SEED)
    print("[3] kernels against their plain versions, main-path shapes")
    with torch.inference_mode():
        rows = [check_fused_stage0(model, gen)]
        row_b, volume = check_gwc_volume(model, gen)
        rows += [row_b, check_stem_agg(model, volume)]
        del volume
        for r in rows:
            print(f"  {r['name']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
        print("  ragged shapes:")
        check_ragged(model, gen)

    print("[4] model on the card against the CPU, 128x256")
    check_against_cpu(gen)

    print(f"[5] {REQUESTS} requests through InferenceRunner, "
          f"{FRAME[0]}x{FRAME[1]} padded to {PADDED[0]}x{PADDED[1]}")
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    serve(model, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        require(n >= REQUESTS,
                f"{name} launched {n} times in {REQUESTS} requests")
    for r in rows:
        r["launches"] = launches[r["name"]]

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
