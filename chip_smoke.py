#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py            # from the root of the repository

Drives twenty served paths with seeded random weights: ten in fp32, and
ten at the deploy numerics that ``bench.py`` measures, bf16 compute with
tanh GELU. Three of those carry every ``fuse_*`` switch (``bench.py``'s
``BENCH_FUSE_*`` settings), with the switches' kernels in their bf16
forms: ``L-deploy-all`` (A writing bf16, F, E, G at 3 levels, H at 2, I),
``M-norm-deploy-all`` (A, F, E's normalised form, G and H at M's widths)
and ``S-deploy-all`` (A's mobilenetv2 form, F at (16, 24), B, C, G and H
with the masked 12-channel tile). The other deploy ones: ``L-deploy``
(kernel A writing bf16, B's bf16 form, C's bf16 form) and
``L-deploy-int8`` (A, B, the quantisation in plain torch ops, C's int8
form); ``M-deploy`` and ``S-deploy`` (A in its efficientnet_b2 or
mobilenetv2 form writing bf16, B's gwc bf16 form, at S the attention
multiply in bf16, C's bf16 form at 24 or 12 bins); ``M-norm-deploy`` (A,
B's normalised bf16 form, C's bf16 form on corr_stem's 1 channel);
``S-norm-deploy`` and ``C-deploy``, the confidence model on it at a KITTI
frame (A's mobilenetv2 form writing bf16, B's normalised bf16 form;
corr_stem, agg and the head plain bf16 modules, as in JAX). The fp32
ones: L default, fused and all; M, M-norm and M-norm-all (cv8); S, S-norm
and S-all (cv16); and ``C``, the confidence model on S-norm, at a KITTI
frame (A, B). It holds each hand-written kernel against its plain PyTorch
version:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build the eight kernel sources from ``esmstereo_tpu_torch/csrc`` (one
     ``nvcc`` per source, all at once) and print ``ptxas`` register/spill
     lines; beside them the ops library (``csrc/torch_ops.cpp``: kernels
     A, B and C's conv as ``esmstereo::`` operators, which their wrappers
     call), the operators' definitions library and the native runner
     (``esmstereo_tpu_torch/serving``, ``g++``);
  3. each kernel and its plain version on the same inputs at the main-path
     shapes (a 540x960 SceneFlow frame padded to 544x992, both eyes), L's,
     M's and S's: max abs / relative error against the stated tolerance,
     CUDA-event times, the bound from bytes and operations, and a yardstick
     the port never calls (cuDNN's convs for C, F, G and H; kernels B + C
     for E, whose gwc form's peak memory must stay below the volume it
     never allocates); the volume in its three forms (gwc, gwc_norm,
     norm-correlation), E's normalised G = 1 form and C on the 1-channel
     volume at M's shapes; each hourglass level, F and I get unit-normal
     inputs, F, I and the normalised volumes are held relative to
     max|plain| with no floor of 1. Each form's distinguishing step must be
     seen: the plain version without it (E's normalised volume, H's
     transposed conv, I's dw 7x7, A's ReLU6 in place of SiLU, the last 4
     channels of F's 24 and of G's and H's 12 at S, B's and C's depths past
     8 at S) must lie at least 100 tolerances away. A's mobilenetv2 form
     and B's normalised form also at C's shapes (a 375x1242 KITTI frame
     padded to 384x1248). The deploy forms at their paths' shapes: A
     writing bf16 (1 bf16 ulp of max(1, max|plain|)); B's gwc bf16 form at
     L, M and S and D's (bit for bit), B's normalised bf16 form at M-norm,
     S-norm and C and D's normalised ones (2 bf16 ulps of max|plain|), each
     form's rounding seen against the other kernel's; C's bf16 and int8
     forms on the gwc volume of L, M and S and on M-norm's corr_stem (1 bf16
     ulp of max(1, max|plain|), at most 1% of the outputs off by any bit,
     the operand rounding and the quantisation each moving more than 1%).
     The switches' bf16 forms at their paths' shapes (E against its plain
     version, B + C's plain bf16 forms, and against kernels B and C's bf16
     forms on the same inputs, with its peak memory below the bf16 volume;
     F, G, H and I), each within 1 bf16 ulp of max(1, max|plain|) on all
     but 1% of its outputs (I: 2 ulps, 15%), the plain version on fp32
     operands moving more than 1% and 5 times that share, I's plain
     version without any one of its rounding steps differing from the
     kernel on more than 15%, and the masked channel tile, H's transposed
     conv, H's 1x1x1 conv's skip half and I's dw 7x7 each moving the plain
     version by 10 tolerances.
     Kernel J, on no served path, over stages 1-5 of L's and S's backbones
     (``check_fused_stages``): from kernel A's output on a seeded image of
     both eyes at 544x992, on a copy of each backbone with weights redrawn
     so that every BN has a shift, each stage within 1e-4 of max(1,
     max|plain|) on the plain chain's input and on the kernel's own chain,
     its SE gate, residual and stride-2 row phase each seen, with the
     served unfused modules (cuDNN convs, BN, SE) as its yardstick.
     The conv3d k3 p1 that C, E's agg, G and H share, conv by conv
     (``check_convs``): each distinct conv shape of L, M and S (C's
     group_stem, M-norm's corr_stem, agg, G's two convs at 3 levels; H's
     and E's have the shapes of G's s1 and C's agg), in fp32 (1e-4) and
     in the deploy form (bf16, and C's first conv on the int8 volume; by
     ``compare_deploy``), beside one cuDNN ``conv3d`` with the folded bias
     and the tile, cluster size and blocks of its launch plan.
     Then each kernel and each deploy form again at small shapes with
     ragged tiles on every axis (J at every stage 0-5 of both backbones,
     odd outputs; G's deploy form conv by conv, each on its own input,
     and as a chain by its max);
  4. each path's model on the card against the same weights on the CPU
     (plain versions) on a 128x256 pair, each map relative to its max|CPU|,
     for each ``fuse_*`` switch set alone at cv4, for L with the
     norm-correlation volume, default and with every switch, and for the
     confidence model's two maps; then, for the paths where kernel F feeds
     match_left (L with ``fuse_stems`` alone, M-norm-all, S-all), four
     draws of fan-in-scaled weights, under which fp32 rounding is
     amplified: the card and the CPU in fp32 each against the CPU in
     float64, the card within 10 times the CPU's own distance, and kernels
     A and F against their plain versions at those weights; then each
     deploy path (the seven served ones, L-norm-deploy and the int8 forms
     of M, M-norm and S) on the card against the same path on the CPU on
     three pairs, beside the CPU's own bf16 distance from the CPU in fp32
     (the deploy numerics' own error), which the card may not exceed on
     the cost, the disparity and the confidence map (in mean pooled over
     the pairs, in max on each pair, by 1 bf16 ulp of the map's peak at
     most), with tests/test_bf16.py's flip and sub-pixel bounds on the
     disparity (at cv4 its mean and flip share held within 1.25 times the
     own figures, and no max); then the three switched paths and each
     switch alone at L-deploy the same way. Every check draws from one
     generator; last among them, F's deploy kernel and H's fused
     transposed + 1x1x1 conv at ragged tiles, each step on its own input
     (``check_ragged_stem_up_tiles``, a [3] check placed here so that no
     earlier draw moves), then A's and I's ragged tiles and their CUDA
     graphs, then kernel B in every form under each of its block shapes
     at column tiles that leave ragged edges and F's fp32 form at odd
     stem_4 widths
     (``check_ragged_volume_stem_tiles``), and B's served forms and F's
     fp32 form captured into CUDA graphs;
  5. for each path, launch counters set to 0, then 3 requests served
     through ``InferenceRunner`` (uint8 540x960 pairs; 375x1242 for C):
     shape, finiteness and time of each; every kernel of the path must
     have launched on each request (G at 3 levels, H at 2), in the path's
     form (bf16 or int8 on the deploy paths, every kernel in bf16 on the
     switched ones, fp32 elsewhere), and no kernel of another path (J on
     none); the shared conv as often as those kernels run it (2 a C, 1
     an E, 2 a G level, 1 an H level), in the path's form, and each conv
     row's shape at least once on its path; H's fused transposed + 1x1x1
     launch (``up_cat_bf16``) once a bf16 H level, never in fp32; the
     separate normalisation (``l2_normalize_pair``) once a normalised E
     call and never for B, whose normalised forms are one launch;
  6. train: ESMStereo-L at full width in fp32 on the SceneFlow recipe
     (AdamW at lr 1e-3, batch 4 of 256x512 crops; synthetic scenes from
     ``data.synthetic.make_scene_batch``, weights from the seeded init):
     ``run_training`` for one epoch of 8 batches (no kernel launched in
     its steps; a checkpoint ``latest_checkpoint`` finds, from which a
     resume gives the parameters, statistics and optimizer state bit for
     bit); 8 steps on one repeated batch bring the loss below 0.8 x the
     first (each step timed by CUDA events, the median after 2 warm-up
     steps, and the peak device memory printed); one train step of S at
     64x128, batch 2, on the card and on the CPU from the same weights
     (float64: gradients within 1e-4 of each tensor's max|g|, running
     statistics within 1e-4; fp32: the card no further from float64 than
     10 times the CPU's fp32 step); kernels B and C raise on an input that
     requires grad and launch under ``no_grad``; the trained L in eval mode
     serves 3 requests (A, B, C once each) and matches the CPU on
     match_left and cost at 1e-4;
  7. the entry points (``esmstereo_tpu_torch.cli``), each ``main`` called
     in process on synthetic trees that the port's own writers make from
     ``make_scene_batch`` scenes (uint8 PNG pairs; PFM or KITTI's uint16
     PNG disparities): a SceneFlow list tree of 4 pairs at 540x960,
     KITTI-2015 ``training/`` (2 pairs at 375x1242, zeros as invalid GT)
     and ``testing/`` trees, a Middlebury and an ETH3D scene with
     non-occlusion masks. ``make_filelists``; ``train_sceneflow`` (L,
     fp32, batch 4 of 256x512 crops, 1 epoch, the 512x960 test crop);
     ``test_kitti`` on its checkpoint in fp32 and in bf16 with tanh GELU;
     ``save_disp``; ``test_mid`` and ``test_eth3d`` at S; ``train_kitti``
     (1 epoch of 1 batch, warm-started from that checkpoint). Each exits
     0 and prints only finite EPEs, each checkpoint exists; the evaluation
     CLIs launch A, B and C once a frame (bf16 forms under
     ``--dtype bfloat16``), the training CLIs none in their steps (A, B, C
     once for their one test batch); ``save_disp``'s PNGs, read back by
     the port's decoder, equal round(clip(disparity, 0, 255) * 256) of
     the runner's output exactly; ``test_kitti`` at M on one pair on the
     card within 1e-4 of max|CPU| of the same CLI with ``--cpu`` on every
     pixel. Each CLI's wall time and ``test_kitti``'s mean forward ms are
     printed beside the card's name and power limit;
  8. export and native serving (``check_serving``) of L-deploy (bf16, tanh
     GELU) and C (the confidence model on S-norm, fp32) at 384x1248, the
     export CLI's default, from the seeded weights [4] holds each at (the
     init rule's; C's ``scale_bn3`` drawn) saved with
     ``train/checkpoints.py``: ``eval/serve_e2e.py`` exports through
     ``cli/export.py`` (an AOTInductor package), serves a seeded 375x1242
     pair with the C++ runner, and runs the package in Python and the
     eager kernel path on the same inputs. The runner's uint16 disparity
     (and C's confidence map) equal the package's in Python through the
     same pre- and post-processing bit for bit; the package holds against
     eager within [4]'s bounds (L-deploy: cv4's deploy bounds pooled over
     three pairs against the eager fp32 path's distance, the sub-pixel
     mean at ``CV4_MARGIN`` as the other two; C: 1e-4 of max|eager| on
     every pixel); the ops library's counters read A 1, B 1 and C's conv
     2 (L-deploy) or 0 (C) a frame, in the runner and in Python. Export
     and compile seconds, the package's size and the runner's ms a frame
     (host clock with the read-back, CUDA events) are printed beside the
     eager request ms of [5] and on the same pair;
  9. a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``cudnn.allow_tf32 = False``, matmul precision
"highest"): the fp32 paths are fp32, and so are the plain versions they
are held against. The tanh-GELU switch is a process global; the deploy
phases set it and restore it in a ``finally``, so the fp32 paths keep
exact GELU. Any failure raises; nothing is caught. Without a CUDA device
the script exits non-zero before it prints a result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from esmstereo_tpu_torch.cli import (make_filelists, save_disp, test_eth3d,
                                     test_kitti, test_mid, train_kitti,
                                     train_sceneflow)
from esmstereo_tpu_torch.data import png
from esmstereo_tpu_torch.data.io import (denormalize_image, pfm_imwrite,
                                         read_all_lines)
from esmstereo_tpu_torch.data.loader import DataLoader
from esmstereo_tpu_torch.data.synthetic import SceneDataset, make_scene_batch
from esmstereo_tpu_torch.eval.runner import InferenceRunner, precision
from esmstereo_tpu_torch.models.confidence import ESMStereoConfidence
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo, ESMStereoConfig,
                                                  conv3d_shapes)
from esmstereo_tpu_torch.ops.kernels import (_build, conv_wrappers,
                                             reset_launches, step_wrappers,
                                             wrappers)
from esmstereo_tpu_torch.ops.kernels import activations
from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
from esmstereo_tpu_torch.ops.kernels import fused_head, fused_hourglass
from esmstereo_tpu_torch.ops.kernels import fused_mixer, fused_stage
from esmstereo_tpu_torch.ops.kernels import fused_stems
from esmstereo_tpu_torch.ops.kernels.activations import gelu
from esmstereo_tpu_torch.backbones import fused as fused_backbone
from esmstereo_tpu_torch.backbones.fused_stage import prepare_stage_consts
from esmstereo_tpu_torch.nn import blocks
from esmstereo_tpu_torch.eval import serve_e2e
from esmstereo_tpu_torch.serving import build as serving_build
from esmstereo_tpu_torch.train import checkpoints
from esmstereo_tpu_torch.train.loop import TrainLoopConfig, run_training
from esmstereo_tpu_torch.train.schedule import lr_schedule_fn
from esmstereo_tpu_torch.train.state import create_train_state
from esmstereo_tpu_torch.train.step import make_train_step

SEED = 0
FRAME = (540, 960)            # SceneFlow; the runner pads to 544 x 992
PADDED = (544, 992)
KITTI_FRAME = (375, 1242)     # KITTI, the confidence model's
KITTI_PADDED = (384, 1248)
REQUESTS = 3
FUSED = ESMStereoConfig(fuse_volume_agg=True, fuse_hourglass=True,
                        fuse_hourglass_up=True)
SWITCHES = ("fuse_volume_agg", "fuse_hourglass", "fuse_hourglass_up",
            "fuse_stems", "fuse_mixer")
EVERY = dict.fromkeys(SWITCHES, True)
ALL = ESMStereoConfig(**EVERY)
M = ESMStereoConfig(cv_scale=8)
M_NORM = ESMStereoConfig(cv_scale=8, cost_volume="norm_correlation")
M_NORM_ALL = ESMStereoConfig(cv_scale=8, cost_volume="norm_correlation",
                             **EVERY)
L_NORM = ESMStereoConfig(cost_volume="norm_correlation")
L_NORM_ALL = ESMStereoConfig(cost_volume="norm_correlation", **EVERY)
S_ARGS = dict(cv_scale=16, backbone="mobilenetv2_100")
S = ESMStereoConfig(**S_ARGS)
S_NORM = ESMStereoConfig(**S_ARGS, cost_volume="norm_correlation")
S_ALL = ESMStereoConfig(**S_ARGS, **EVERY)
# the deploy numerics of bench.py (bf16 compute, tanh GELU), with and
# without the int8 volume
def deploy(config: ESMStereoConfig, **kw) -> ESMStereoConfig:
    return dataclasses.replace(config, dtype="bfloat16", **kw)


# the served deploy paths (C-deploy's config is the confidence model's
# ESMStereo-S); the int8 forms of M, M-norm and S and L-norm-deploy are
# held against the CPU in [4] only
DEPLOY_PATHS = {"L-deploy": deploy(ESMStereoConfig()),
                "L-deploy-int8": deploy(ESMStereoConfig(), volume_int8=True),
                "M-deploy": deploy(M), "M-norm-deploy": deploy(M_NORM),
                "S-deploy": deploy(S), "S-norm-deploy": deploy(S_NORM),
                "C-deploy": deploy(S_NORM)}
CPU_HELD_DEPLOY = {"L-norm-deploy": deploy(L_NORM),
                   "M-deploy-int8": deploy(M, volume_int8=True),
                   "M-norm-deploy-int8": deploy(M_NORM, volume_int8=True),
                   "S-deploy-int8": deploy(S, volume_int8=True)}
# the deploy numerics with the switches (bench.py's BENCH_FUSE_* paths):
# served, and each switch alone at L-deploy held against the CPU in [4]
# only
SWITCHED_PATHS = {"L-deploy-all": deploy(ALL),
                  "M-norm-deploy-all": deploy(M_NORM_ALL),
                  "S-deploy-all": deploy(S_ALL)}
CPU_HELD_SWITCHED = {f"L-deploy {k} alone":
                     deploy(ESMStereoConfig(**{k: True})) for k in SWITCHES}
# the paths whose bf16 maps are held to the CPU's own max distance from
# fp32 with no ulp of slack in [4] (their costs' own distance is over one
# ulp)
STRICT_DEPLOY = ("L-deploy", "L-deploy-int8")
# cv4's deploy disparity on the card against the CPU: the card's and the
# CPU's bf16 runs round at other places, and the top-2 regression flips a
# pixel whose two peaks nearly tie on either perturbation, as bf16 against
# fp32 does, so the card's distance and the deploy numerics' own are the
# same kind of figure and a single draw can put either above the other
# (measured on the H100 over the nine cv4 deploy paths: the card's mean
# distance 0.44-1.10 times the own over 74 single draws, 9 of them above
# 1; pooled over three draws 0.51-0.93 times, its flip share 0.56-0.91
# times). They are pooled over DEPLOY_DRAWS pairs and held within
# CV4_MARGIN times the own figures.
# The int8 volume does the same to the cost at cv8 and cv16: a bf16 ulp
# that the card and the CPU round apart before the quantisation moves a
# value near max|volume| by half an int8 step, so the two runs land on
# other int8 levels about as often as the int8 run does against fp32 and
# one draw can put the card's mean distance above the own (measured on
# the H100, S-deploy-int8's cost: 0.59-1.06 times the own over 24 single
# draws, 1 of them above 1, on this code and on the code before kernel J
# alike). Every deploy path's cost and confidence means are therefore
# pooled over DEPLOY_DRAWS pairs at 1 times the own; their maxima, and
# the disparity's at cv8 and cv16, are held on every pair.
DEPLOY_DRAWS = 3
CV4_MARGIN = 1.25
# deploy paths with their bf16 activations per op (nn.blocks.
# set_bf16_per_op: jax.nn's formulas rounding after every op, one launch
# of the activations_bf16 kernel each), which the JAX reference computes;
# held against the CPU in [4] and served in [5]. The served mode rounds
# once (torch's functions): per op, L-deploy's chaotic cv4 disparity
# moves past its JAX test on the tests' draw (ROADMAP section 3 item 1).
# M-deploy reaches the tanh GELU, SiLU and sigmoid, C-deploy those and
# the softmax.
PER_OP_PATHS = {"M-deploy per-op": deploy(M),
                "C-deploy per-op": deploy(S_NORM)}
# multiply-adds per /4 pixel of kernel I: to_feat, two FMBlocks (two
# SMLayers of two 8 -> 16 -> 8 MLPs and a dw 7x7 each, expand, project), up
MIXER_MACS = (32 * 9 * 16
              + 2 * (2 * (2 * 2 * 8 * 16 + 16 * 49) + 16 * 9 * 32 + 32 * 16)
              + 16 * 64)
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 on the
# CUDA cores, and bf16 on the tensor cores (dense), the rate of the deploy
# forms' bf16 operands (int8 times bf16 weights counts as bf16): the least
# time for their work, though these first forms run fp32 FMA.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


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


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time on the card in ms, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require(ok, what: str) -> None:
    """Fail the run (a check that ``python -O`` keeps, unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float, floor: float = 1.0, min_peak: float = 0.1) -> float:
    """Max abs error; fails unless it is within
    ``rtol * max(floor, max|want|)``. With ``floor`` 0 it also fails when
    max|want| < ``min_peak``, where a relative bound would see too little
    (the norm-correlation volume's entries are means of 64 products of
    unit-vector components, at most 1/64)."""
    require(got.shape == want.shape,
            f"{name}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
    require(torch.isfinite(got).all(), f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    if floor == 0.0:
        require(peak >= min_peak,
                f"{name}: max|plain| {peak:.3e} < {min_peak:g}")
    scale = max(floor, peak)
    print(f"  {name}: max abs err {err:.3e}, relative {err / scale:.3e} "
          f"(tolerance {rtol:g} relative; max|plain| {peak:.3e})")
    require(err <= rtol * scale,
            f"{name}: kernel disagrees with its plain version")
    return err


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def compare_ulps(name: str, got: torch.Tensor, want: torch.Tensor,
                 ulps: float = 1.0) -> float:
    """Max abs error of a deploy form against its plain version; fails
    unless it is within ``ulps`` bf16 ulps of max(1, max|plain|): both run
    fp32 sums in other orders, which can move a bf16 rounding by one
    ulp."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype}, plain "
            f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    require(torch.isfinite(g).all(), f"{name}: non-finite kernel output")
    err = float((g - w).abs().max())
    peak = float(w.abs().max())
    tol = ulps * bf16_ulp(max(1.0, peak))
    print(f"  {name}: max abs err {err:.3e} (tolerance {ulps:g} bf16 ulp of "
          f"max(1, max|plain|) = {tol:.3e}; max|plain| {peak:.3e}); "
          f"{apart(got, want):.3e} of the outputs differ")
    require(err <= tol, f"{name}: kernel disagrees with its plain version")
    return err


def apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of the elements where ``a`` and ``b`` differ."""
    return float((a.float() != b.float()).float().mean())


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (a process global), restored after.
    The ones it picks by default for the unfused hourglass's bf16 3-D
    convs on the H100 sum in an order that changes from run to run, which
    moves a bf16 rounding of a deploy path's cost by one ulp between runs
    on one input (L-deploy's max distance from the CPU read 4.470e-08 or
    5.215e-08 on one draw, against the deploy numerics' own 4.863e-08)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@contextlib.contextmanager
def bf16_per_op(enabled: bool = True):
    """The bf16 activations per op (``nn.blocks.set_bf16_per_op``, a
    process global), restored after."""
    before = blocks.BF16_PER_OP
    blocks.set_bf16_per_op(enabled)
    try:
        yield
    finally:
        blocks.set_bf16_per_op(before)


@contextlib.contextmanager
def tanh_gelu():
    """The deploy numerics' tanh GELU (a process global), restored after."""
    before = blocks.GELU_APPROXIMATE
    blocks.set_gelu_approximate(True)
    try:
        yield
    finally:
        blocks.set_gelu_approximate(before)


def require_seen(what: str, blind: torch.Tensor, want: torch.Tensor,
                 rtol: float, floor: float = 1.0) -> None:
    """Fail unless ``blind`` (the plain version without the step ``what``
    names: a weight zeroed or an activation swapped) lies at least 100
    tolerances from ``want``, the tolerance of ``compare`` with the same
    ``rtol`` and ``floor``: the comparison sees that step."""
    gap = float((blind - want).abs().max())
    tol = rtol * max(floor, float(want.abs().max()))
    print(f"    without {what} the plain version moves {gap:.3e} (at least "
          f"100 tolerances: {100 * tol:.3e})")
    require(gap >= 100 * tol, f"the comparison cannot see {what}")


def mobilenetv2_clamped(consts: dict) -> dict:
    """Kernel A's mobilenetv2_100 consts with the stem's folded weights
    scaled x16, so that the stem's ReLU6 clamps at 6 on part of a
    unit-normal image."""
    consts = dict(consts, stem_w=consts["stem_w"] * 16.0,
                  stem_b=consts["stem_b"] * 16.0)
    consts["packed"] = fused_head.pack_params(consts)
    return consts


def check_fused_stage0(model, gen, path, padded=PADDED) -> dict:
    """Kernel A at a main path's shapes (both eyes, ``padded``: 544 x 992,
    or 384 x 1248 on the confidence path) in the form of ``model``'s
    backbone. In mobilenetv2_100's form the stem's folded
    weights are scaled x16, so that the stem's ReLU6 clamps at 6 on part of
    the image, and the plain version with SiLU in place of the dw's ReLU6
    (efficientnet_b2's activation) must lie at least 100 tolerances
    away."""
    dev = torch.device("cuda")
    img = torch.randn((2, 3, *padded), generator=gen).to(dev)
    consts = fused_backbone.prepare_consts(model.feature)
    form = fused_head.kernel_form(consts)
    if form == "mobilenetv2_100":
        consts = mobilenetv2_clamped(consts)
        stem = torch.nn.functional.conv2d(img, consts["stem_w"],
                                          consts["stem_b"], stride=2,
                                          padding=1)
        above = float((stem > 6.0).float().mean())
        print(f"  fused_stage0 {form} {tuple(img.shape)}: {above:.2%} of "
              f"the stem's values above 6 before the clamp")
        require(above > 0.01, "fused_stage0: the stem never reaches 6")
    got = fused_head.fused_stage0(img, consts)
    want = fused_head.stage0_plain(img, consts)
    # fp32; the SE means sum 135k pixels in another order than torch's mean
    err = compare(f"fused_stage0 {form} {tuple(img.shape)}", got, want, 1e-4)
    if form == "mobilenetv2_100":
        require_seen("the dw's ReLU6 (SiLU in its place)",
                     fused_head.stage0_plain(img, dict(consts, act="silu")),
                     want, 1e-4)
    b, _, h, w = img.shape
    px = b * (h // 2) * (w // 2)
    macs = px * (consts["stem_w"].numel() + sum(
        blk["dw_w"].numel() + blk["pw_w"].numel()
        for blk in consts["blocks"]))
    bms, by = bound(nbytes(img, consts["packed"], got), 2 * macs)
    return {"name": "fused_stage0", "form": form, "model": variant(model)[0],
            "path": path, "route": "cuda", "input": list(img.shape),
            "source": "esmstereo_tpu_torch/csrc/fused_head.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_head.py:198",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_head.fused_stage0(img, consts)),
            "plain_ms": cuda_ms(lambda: fused_head.stage0_plain(img, consts)),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def variant(model) -> str:
    """``L``, ``M`` or ``S``, with ``-norm`` for the norm-correlation
    volume."""
    cfg = model.config
    name = {4: "L", 8: "M", 16: "S"}[cfg.cv_scale]
    return name + ("-norm" if cfg.cost_volume == "norm_correlation" else "")


def desc_shape(model, padded=PADDED) -> tuple:
    """A main path's (1, 64, H/v, W/v) descriptor map at cv_scale v for a
    ``padded`` frame of H x W."""
    v = model.config.cv_scale
    return (1, 64, padded[0] // v, padded[1] // v)


# (groups, normalize) of each form of the volume
FORMS = {"gwc": (32, False), "gwc_norm": (32, True), "norm": (1, True)}


def volume_flops(entries: int, groups: int, desc: torch.Tensor,
                 normalize: bool) -> int:
    """Products, sum and 1/n per entry of a volume of ``entries`` values in
    ``groups`` groups, built from two maps of ``desc``'s shape; with
    normalize, per input value of both maps a square-add and a division.
    Kernels B/D and E count the volume with this one function."""
    cpg = desc.shape[1] // groups
    return entries * (2 * cpg + 1) + (6 * desc.numel() if normalize else 0)


def check_correlation_volume(model, gen, form: str, path, padded=PADDED
                             ) -> tuple[dict, torch.Tensor]:
    """Kernels B and D in one form at a main path's shapes of ``model``:
    (1, 64, H/v, W/v) descriptors of a ``padded`` frame, ``model.num_bins``
    bins. The normalised forms are held relative to max|plain| with no
    floor of 1."""
    dev = torch.device("cuda")
    shape = desc_shape(model, padded)
    ref = torch.randn(shape, generator=gen).to(dev)
    tgt = torch.randn(shape, generator=gen).to(dev)
    d = model.num_bins
    g, norm = FORMS[form]

    def kernel():
        return correlation.correlation_volume(ref, tgt, d, g, normalize=norm)

    def plain():
        return correlation.correlation_volume_plain(ref, tgt, d, g, norm)

    got = kernel()
    want = plain()
    name = f"correlation_volume {form} {variant(model)[0]} {tuple(got.shape)}"
    floor = 0.0 if norm else 1.0
    err = compare(name, got, want, 1e-5, floor=floor, min_peak=1e-3)
    if d % 8:
        # the bins past the last multiple of 8 (S's 12 = 8 + 4)
        blind = want.clone()
        blind[:, :, d - d % 8:] = 0.0
        require_seen(f"bins {d - d % 8}..{d - 1}", blind, want, 1e-5, floor)
    bms, by = bound(nbytes(ref, tgt, got),
                    volume_flops(got.numel(), g, ref, norm))
    row = {"name": "correlation_volume", "form": form,
           "model": variant(model)[0], "path": path, "route": "cuda",
           "source": "esmstereo_tpu_torch/csrc/correlation.cu",
           "replaces": ("esmstereo_tpu/ops/pallas/correlation.py:249 (D); "
                        "esmstereo_tpu/ops/pallas/correlation.py:132 (B)"),
           "input": list(shape), "output": list(got.shape),
           "max_abs_err": err, "ms": cuda_ms(kernel),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": None}
    return row, got


def check_stem_agg(model, volume: torch.Tensor, path) -> dict:
    """Kernel C on a volume of ``model``'s main path: B's (1, 32, D, H/v,
    W/v) or, for the norm-correlation models, a unit-normal (1, 1, D, H/v,
    W/v) volume through corr_stem (the normalised volume itself is at most
    1/64, too small for a tolerance with a floor of 1 to see)."""
    consts = fused_agg_stem.prepare_consts(model.volume_stem, model.agg)
    approx = blocks.GELU_APPROXIMATE
    got = fused_agg_stem.stem_agg(volume, consts, approx)
    want = fused_agg_stem.stem_agg_plain(volume, consts, approx)
    ci, co = volume.shape[1], got.shape[1]
    # fp32 sums of up to 864 and 216 products in another order than cuDNN's
    err = compare(f"stem_agg {variant(model)} {tuple(volume.shape)}", got,
                  want, 1e-4)
    d = volume.shape[2]
    if d % 8:
        # the partial depth chunk of the conv's 8-deep tiles (S: 12 = 8 + 4)
        cut = volume.clone()
        cut[:, :, d - d % 8:] = 0.0
        require_seen(f"the volume's depths {d - d % 8}..{d - 1}",
                     fused_agg_stem.stem_agg_plain(cut, consts, approx),
                     want, 1e-4)
    vox = got.numel() // co
    flops = 2 * vox * 27 * (ci * co + co * co)
    bms, by = bound(nbytes(volume, consts["w1"], consts["t1"], consts["w2"],
                           consts["t2"], got), flops)

    def library():
        y = torch.nn.functional.conv3d(volume, consts["w1"], consts["t1"],
                                       padding=1)
        return torch.nn.functional.conv3d(y, consts["w2"], consts["t2"],
                                          padding=1)

    return {"name": "stem_agg", "form": "norm" if ci == 1 else "gwc",
            "model": variant(model)[0], "path": path, "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_agg_stem.py:162",
            "input": list(volume.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_agg_stem.stem_agg(volume, consts,
                                                          approx)),
            "plain_ms": cuda_ms(lambda: fused_agg_stem.stem_agg_plain(
                volume, consts, approx)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)}


def require_b_then_c(name: str, got: torch.Tensor, b_c: torch.Tensor,
                     form: str, g: int, d: int, h: int, w: int,
                     desc_bytes: int = 4) -> None:
    """Kernel E's output bit for bit against kernels B then C on the same
    inputs: E's group_stem runs the chunks and cluster split of C's plan
    (``fused_agg_stem.volume_plan``, printed beside C's; the bf16 forms may
    take a larger tile, which does not enter the sums), so it sums the same
    products in the same order."""
    plan = fused_agg_stem.volume_plan(form, g, d, h, w, desc_bytes)
    conv, c_conv = plan.conv, fused_hourglass.conv_plan(form, g, 8, d, h, w,
                                                        1)
    producers = (f"{plan.load_warps} producer warps" if form != "fp32"
                 else f"units of {plan.sub} channels")
    print(f"  {name}: plan tile {conv.tile}, cluster {conv.cluster}, "
          f"{conv.blocks} blocks of {plan.threads} threads, {producers}, "
          f"{plan.smem} bytes of shared memory (C's group_stem: tile "
          f"{c_conv.tile}, cluster {c_conv.cluster}, {c_conv.smem} bytes); "
          f"{apart(got, b_c):.3e} of the outputs differ from kernels B + C")
    require((conv.cluster, conv.ranks) == (c_conv.cluster, c_conv.ranks)
            and torch.equal(got, b_c),
            f"{name}: differs from kernels B then C in its split or bits")


def check_volume_stem_agg(model, gen, path) -> dict:
    """Kernel E at the main path's shapes of ``model``: (1, 64, H/v, W/v)
    descriptors, ``model.num_bins`` bins, the gwc volume (32 groups) or the
    normalised G = 1 one. Beside its time, kernels B + C on the same inputs
    (the default path's way to the same result). Its peak memory over one
    call must stay within its own scratch (the two normalised maps, in
    that form), the 8-channel intermediate and the output; in the gwc
    form also below the (1, 32, D, H/v, W/v) volume's bytes. At G = 1 the
    two 8-channel tensors alone are 16 times the 1-channel volume, so
    that form cannot save memory over B + C. The normalised volume is at most 1/64, so for that form the
    check scales corr_stem's folded weights by 64, holds the output
    relative to max|plain| with no floor of 1, and the plain version with
    those weights zeroed must lie at least 100 tolerances away: the
    comparison sees the volume."""
    dev = torch.device("cuda")
    shape = desc_shape(model)
    ref = torch.randn(shape, generator=gen).to(dev)
    tgt = torch.randn(shape, generator=gen).to(dev)
    d, g = model.num_bins, model.volume_groups
    norm = model.config.cost_volume == "norm_correlation"
    consts = fused_agg_stem.prepare_consts(model.volume_stem, model.agg)
    if norm:
        consts = dict(consts, w1=consts["w1"] * 64.0)
    approx = blocks.GELU_APPROXIMATE

    def kernel():
        return fused_agg_stem.volume_stem_agg(ref, tgt, consts, d, g, approx,
                                              normalize=norm)

    def plain(c=consts):
        return fused_agg_stem.volume_stem_agg_plain(ref, tgt, c, d, g,
                                                    approx, norm)

    def b_plus_c():
        vol = correlation.correlation_volume(ref, tgt, d, g, normalize=norm)
        return fused_agg_stem.stem_agg(vol, consts, approx)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = kernel()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    volume_bytes = shape[0] * g * d * shape[2] * shape[3] * 4

    def block(n: int) -> int:
        """The most the caching allocator counts for ``n`` bytes: 512-byte
        rounding, and above 1 MiB a block's unsplit tail of up to 1 MiB."""
        return -(-n // 512) * 512 + (1 << 20 if n > 1 << 20 else 0)

    # the normalised maps' scratch, the 8-channel intermediate, the output
    own_bytes = ((2 * block(ref.numel() * 4) if norm else 0)
                 + 2 * block(got.numel() * 4))
    print(f"  volume_stem_agg {variant(model)}: peak {peak / 1e6:.1f} MB over "
          f"one call (its scratch, intermediate and output: "
          f"{own_bytes / 1e6:.1f} MB); the volume it never allocates: "
          f"{volume_bytes / 1e6:.1f} MB")
    require(peak <= own_bytes, "volume_stem_agg allocated more than its "
            "scratch, intermediate and output")
    if not norm:
        require(peak < volume_bytes,
                "volume_stem_agg allocated as much as the volume")
    want = plain()
    # fp32 sums of 864 and 216 products in another order than cuDNN's
    err = compare(f"volume_stem_agg {variant(model)} {tuple(got.shape)}",
                  got, want, 1e-4, floor=0.0 if norm else 1.0,
                  min_peak=0.01)
    require_b_then_c(f"volume_stem_agg {variant(model)}", got, b_plus_c(),
                     "fp32", g, d, *shape[2:])
    if norm:
        require_seen("the volume", plain(dict(
            consts, w1=torch.zeros_like(consts["w1"]))), want, 1e-4, 0.0)
    vox = got.numel() // got.shape[1]
    co = got.shape[1]
    flops = (volume_flops(vox * g, g, ref, norm)          # the volume
             + 2 * vox * 27 * (g * co + co * co))         # group_stem + agg
    bms, by = bound(nbytes(ref, tgt, *consts.values(), got), flops)
    return {"name": "volume_stem_agg", "form": "norm" if norm else "gwc",
            "model": variant(model)[0], "path": path, "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_volume_agg.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_agg_stem.py:323",
            "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "b_plus_c_ms": cuda_ms(b_plus_c),
            "peak_mb": peak / 1e6}


def level_rows(name: str, source: str, replaces: str, model, path,
               levels) -> dict:
    """One kernel's row from its per-level rows: times and bounds summed
    over the levels of one frame, the largest error."""
    row = {"name": name, "model": variant(model)[0], "path": path,
           "route": "cuda", "source": source, "replaces": replaces,
           "max_abs_err": max(lv["max_abs_err"] for lv in levels)}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        row[key] = sum(lv[key] for lv in levels)
    row["bound_by"] = max(levels, key=lambda lv: lv["bound_ms"])["bound_by"]
    row["levels"] = levels
    return row


def tail_zeroed(consts: dict, keys, first: int) -> dict:
    """``consts`` with the output channels from ``first`` on zeroed in the
    weights and shifts ``keys`` (each with its output channels first)."""
    out = dict(consts)
    for k in keys:
        out[k] = consts[k].clone()
        out[k][first:] = 0.0
    return out


def check_down_pairs(model, gen, path) -> tuple[dict, list]:
    """Kernel G at each of the hourglass's 3 down levels at the main path's
    shapes of ``model`` (level 1 takes kernel C's (1, 8, D, H/v, W/v)
    output shape, each next level the previous one's output shape). Each
    level gets unit-normal inputs, not the previous level's output: random
    weights shrink a signal chained through them until a tolerance with a
    floor of 1 cannot see it. Returns the row and the 3 output shapes."""
    agg = model.aggregation_out
    approx = blocks.GELU_APPROXIMATE
    levels, shapes = [], []
    shape = (1, 8, model.num_bins, *desc_shape(model)[2:])
    for k in (1, 2, 3):
        consts = fused_hourglass.prepare_down_consts(
            getattr(agg, f"conv{k}_0"), getattr(agg, f"conv{k}_1"))
        x = torch.randn(shape, generator=gen).cuda()
        got = fused_hourglass.down_pair(x, consts, approx)
        want = fused_hourglass.down_pair_plain(x, consts, approx)
        # fp32 sums of up to 27 * 72 products in another order than cuDNN's
        err = compare(f"down_pair {variant(model)[0]} level {k} "
                      f"{tuple(x.shape)}", got, want, 1e-4)
        ci, co = x.shape[1], got.shape[1]
        if co % 8:
            tail = co - co % 8     # the masked channel tile's first channel
            require_seen(f"channels {tail}..{co - 1}",
                         fused_hourglass.down_pair_plain(
                             x, tail_zeroed(consts, ("wb", "tb"), tail),
                             approx), want, 1e-4)
        vox = got.numel() // co
        flops = 2 * vox * co * 27 * (ci + co)
        bms, by = bound(nbytes(x, *consts.values(), got), flops)

        def library(x=x, c=consts):
            y = torch.nn.functional.conv3d(x, c["wa"], c["ta"], stride=2,
                                           padding=1)
            return torch.nn.functional.conv3d(y, c["wb"], c["tb"], padding=1)

        levels.append({
            "level": k, "input": list(x.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda x=x, c=consts: fused_hourglass.down_pair(
                x, c, approx)),
            "plain_ms": cuda_ms(lambda x=x, c=consts:
                                fused_hourglass.down_pair_plain(x, c, approx)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)})
        shapes.append(tuple(got.shape))
        shape = tuple(got.shape)
    return level_rows("down_pair", "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
                      "esmstereo_tpu/attic/fused_hourglass.py:144", model,
                      path, levels), shapes


def check_up_pairs(model, gen, downs: list, path) -> dict:
    """Kernel H at the hourglass's 2 up levels at the main path's shapes of
    ``model`` (``downs``, kernel G's 3 output shapes): src conv3 with skip
    conv2, then src conv2 with skip conv1, each src and skip unit-normal.
    The plain version with the transposed conv zeroed must lie at least 100
    tolerances away, so that the comparison sees the transposed conv."""
    agg = model.aggregation_out
    approx = blocks.GELU_APPROXIMATE
    levels = []
    for k, (names, src_shape, skip_shape) in enumerate(
            ((("conv3_up", "agg_0_0", "agg_0_1"), downs[2], downs[1]),
             (("conv2_up", "agg_1_0", "agg_1_1"), downs[1], downs[0])),
            start=1):
        consts = fused_hourglass.prepare_up_consts(
            *(getattr(agg, n) for n in names))
        src = torch.randn(src_shape, generator=gen).cuda()
        skip = torch.randn(skip_shape, generator=gen).cuda()
        got = fused_hourglass.up_pair(src, skip, consts, approx)
        want = fused_hourglass.up_pair_plain(src, skip, consts, approx)
        err = compare(f"up_pair {variant(model)[0]} level {4 - k}->{3 - k} "
                      f"src {tuple(src.shape)}", got, want, 1e-4)
        require_seen("the transposed conv", fused_hourglass.up_pair_plain(
            src, skip, dict(consts, wu=torch.zeros_like(consts["wu"]),
                            tu=torch.zeros_like(consts["tu"])), approx),
            want, 1e-4)
        ci, co = src.shape[1], got.shape[1]
        if co % 8:
            tail = co - co % 8
            require_seen(f"channels {tail}..{co - 1}",
                         fused_hourglass.up_pair_plain(
                             src, skip, tail_zeroed(consts, ("w3", "t3"),
                                                    tail), approx),
                         want, 1e-4)
        vox = got.numel() // co
        # the transposed conv's 8 taps per output, the 1x1x1, the 3x3x3
        flops = 2 * vox * co * (8 * ci + 2 * co + 27 * co)
        bms, by = bound(nbytes(src, skip, *consts.values(), got), flops)
        d2, h2, w2 = skip.shape[2:]

        def library(s=src, k_=skip, c=consts):
            f = torch.nn.functional
            up = f.conv_transpose3d(s, c["wu"], c["tu"], stride=2,
                                    padding=1)[:, :, :d2, :h2, :w2]
            z = f.conv3d(torch.cat([up, k_], dim=1), c["wc"], c["tc"])
            return f.conv3d(z, c["w3"], c["t3"], padding=1)

        levels.append({
            "level": f"{4 - k}->{3 - k}", "input": list(src.shape),
            "skip": list(skip.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda s=src, k_=skip, c=consts:
                          fused_hourglass.up_pair(s, k_, c, approx)),
            "plain_ms": cuda_ms(lambda s=src, k_=skip, c=consts:
                                fused_hourglass.up_pair_plain(s, k_, c,
                                                              approx)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)})
    return level_rows("up_pair", "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
                      "esmstereo_tpu/attic/fused_hourglass.py:453", model,
                      path, levels)


def check_stems(model, gen, path) -> dict:
    """Kernel F at the main path's shapes: both eyes, 544 x 992, a
    unit-normal image (x4 at S's widths, whose narrower seeded towers leave
    stem_4's output under the 0.1 that a bound relative to max|plain| needs
    otherwise); both outputs held relative to max|plain|. At S's widths
    (16, 24) the plain version with stem_4's last 4 channels zeroed (past
    the 16-channel split of L's instance) must lie at least 100 tolerances
    away."""
    img = torch.randn((2, 3, *PADDED), generator=gen).cuda()
    consts = fused_stems.prepare_consts(model.stem_2, model.stem_4)
    c2, c4 = fused_stems.widths(consts)
    if c4 % 16:
        img = img * 4.0
    approx = blocks.GELU_APPROXIMATE
    got = fused_stems.stems(img, consts, approx)
    want = fused_stems.stems_plain(img, consts, approx)
    # fp32 sums of up to 48 * 9 products in another order than cuDNN's
    err = max(compare(f"stems {name} {tuple(w.shape)}", g, w, 1e-4,
                      floor=0.0)
              for name, g, w in zip(("stem_2", "stem_4"), got, want))
    if c4 % 16:
        # the (C, 3, 3, CO) weights hold their output channels last
        blind = {k: v.clone() for k, v in consts.items()}
        blind["wc4"][..., c4 - 4:] = 0.0
        blind["tc4"][c4 - 4:] = 0.0
        require_seen(f"stem_4's channels {c4 - 4}..{c4 - 1}",
                     fused_stems.stems_plain(img, blind, approx)[1], want[1],
                     1e-4, 0.0)
    b, _, h, w = img.shape
    px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    macs = px2 * c2 * (3 + c2) * 9 + px4 * c4 * (c2 + c4) * 9
    # the kernel's work: three TF32 products (3xTF32) a multiply-add on the
    # tensor cores
    bms, by = bound(nbytes(img, *consts.values(), *got), 3 * 2 * macs,
                    TF32_FLOPS_PER_S)
    torch_w = {k: v.permute(3, 0, 1, 2).contiguous()
               for k, v in consts.items() if v.ndim == 4}

    def library():
        f = torch.nn.functional
        x = img
        for s in "24":
            x = gelu(f.conv2d(x, torch_w[f"wd{s}"], consts[f"td{s}"],
                              stride=2, padding=1), approx)
            x = f.relu(f.conv2d(x, torch_w[f"wc{s}"], consts[f"tc{s}"],
                                padding=1))
        return x

    return {"name": "stems", "form": f"{c2}, {c4} fp32 (3xTF32)",
            "model": variant(model)[0], "path": path, "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_stems.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_stems.py:174",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_stems.stems(img, consts, approx)),
            "plain_ms": cuda_ms(lambda: fused_stems.stems_plain(
                img, consts, approx)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(library)}


def check_mixer(model, gen) -> dict:
    """Kernel I at the main path's shapes: a unit-normal (1, 32, 136, 248)
    spx output, held relative to max|plain|. The plain version with
    block1.sm2's dw 7x7 zeroed must lie at least 100 tolerances away, so
    that the comparison sees the section's deepest spatial step."""
    x = torch.randn((1, 32, PADDED[0] // 4, PADDED[1] // 4),
                    generator=gen).cuda()
    consts = fused_mixer.prepare_consts(model.upsample_module.stage2x)
    got = fused_mixer.mixer(x, consts)
    want = fused_mixer.mixer_plain(x, consts)
    # fp32 through 18 chained convs and MLPs, sums of up to 288 products
    err = compare(f"mixer {tuple(x.shape)}", got, want, 1e-4, floor=0.0)
    blind = {"packed": consts["packed"].clone()}
    fused_mixer.unpack(blind["packed"])["block1.sm2.dw_w"].zero_()
    require_seen("block1.sm2's dw 7x7", fused_mixer.mixer_plain(x, blind),
                 want, 1e-4, 0.0)
    px = x.shape[0] * x.shape[2] * x.shape[3]
    bms, by = bound(nbytes(x, consts["packed"], got), 2 * px * MIXER_MACS)
    return {"name": "mixer", "model": "L", "path": "all", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_mixer.cu",
            "replaces": "esmstereo_tpu/attic/fused_mixer.py:212",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_mixer.mixer(x, consts)),
            "plain_ms": cuda_ms(lambda: fused_mixer.mixer_plain(x, consts)),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


# --- the deploy forms (bf16 compute, tanh GELU, optional int8 volume) --------

def check_fused_stage0_bf16(net, gen, path: str, padded=PADDED) -> dict:
    """Kernel A's bf16-out form in the form of ``net``'s backbone at a
    deploy path's shapes (both eyes, ``padded``): the kernel's bf16 output
    against the fp32 plain version cast to bf16, within 1 bf16 ulp of
    max(1, max|plain|). In mobilenetv2_100's form the stem is scaled as in
    ``check_fused_stage0`` (its ReLU6 clamps)."""
    img = torch.randn((2, 3, *padded), generator=gen).cuda()
    consts = fused_backbone.prepare_consts(net.feature)
    form = fused_head.kernel_form(consts)
    if form == "mobilenetv2_100":
        consts = mobilenetv2_clamped(consts)
    bf16 = torch.bfloat16

    def kernel():
        return fused_head.fused_stage0(img, consts, bf16)

    def plain():
        return fused_head.stage0_plain(img, consts).to(bf16)

    got = kernel()
    err = compare_ulps(f"fused_stage0 {form} bf16 out {tuple(img.shape)}",
                       got, plain())
    b, _, h, w = img.shape
    macs = b * (h // 2) * (w // 2) * (consts["stem_w"].numel() + sum(
        blk["dw_w"].numel() + blk["pw_w"].numel()
        for blk in consts["blocks"]))
    bms, by = bound(nbytes(img, consts["packed"], got), 2 * macs)
    return {"name": "fused_stage0", "form": f"{form} bf16 out",
            "model": path, "path": path, "form_key": "bf16",
            "route": "cuda", "input": list(img.shape),
            "source": "esmstereo_tpu_torch/csrc/fused_head.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_head.py:198",
            "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
            "library_ms": None}


# the share of a normalised bf16 volume's entries that must equal the plain
# version's bits (measured 99.984-100% on the card)
MIN_EXACT = 0.999


def compare_volume_ulps(name: str, got: torch.Tensor, want: torch.Tensor,
                        ulps: float = 2.0) -> float:
    """A normalised bf16 volume against its plain version: fails unless at
    least ``MIN_EXACT`` of the entries are bit-exact and every entry is
    within ``ulps`` bf16 ulps of max|plain| (with no floor of 1: the
    norm-correlation volume's entries are at most 1/64). The two normalise
    in fp32 in other orders, so a product may round to bf16 the other way,
    moving its entry by up to one ulp of that product over C/G, and the
    entry's own rounding by one more. Prints the largest distance in ulps
    of each entry's own magnitude; returns the max abs error."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype}, plain "
            f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    require(torch.isfinite(g).all(), f"{name}: non-finite kernel output")
    peak = float(w.abs().max())
    tol = ulps * bf16_ulp(peak)
    err = float((g - w).abs().max())
    exact = 1.0 - apart(got, want)
    mag = torch.maximum(g.abs(), w.abs())
    own = torch.exp2(torch.floor(torch.log2(torch.where(
        mag > 0, mag, torch.ones_like(mag)))) - 7)
    print(f"  {name}: {exact:.6%} of the entries bit-exact (at least "
          f"{MIN_EXACT:.1%}), max abs err {err:.3e} (tolerance {ulps:g} "
          f"bf16 ulp of max|plain| {peak:.3e} = {tol:.3e}), at most "
          f"{float(((g - w).abs() / own).max()):g} ulps of the entry itself")
    require(exact >= MIN_EXACT and err <= tol,
            f"{name}: kernel disagrees with its plain version")
    return err


def check_correlation_bf16(net, gen, form: str, path: str | None,
                           padded=PADDED, round_products: bool = True
                           ) -> tuple[dict, torch.Tensor]:
    """Kernel B's (``round_products``) or D's bf16 ``form`` (gwc, gwc_norm,
    norm) at the shapes of ``net``'s path: (1, 64, H/v, W/v) bf16
    descriptors of a ``padded`` frame, ``net.num_bins`` bins. The gwc forms
    must equal their plain versions on every entry (the products of two
    bf16 values are exact in fp32 and the sums of 2 exact too); the
    normalised ones, whose fp32 normalisation and sums run in another
    order, bit-exact on at least ``MIN_EXACT`` of the entries and within 2
    bf16 ulps of max|plain| (``compare_volume_ulps``). The plain version
    with the other kernel's rounding must fail that criterion: the
    comparison tells the form from its neighbour. Returns the row and the
    volume."""
    shape = desc_shape(net, padded)
    ref = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
    tgt = torch.randn(shape, generator=gen).cuda().to(torch.bfloat16)
    d = net.num_bins
    g, norm = FORMS[form]

    def kernel():
        return correlation.correlation_volume(ref, tgt, d, g, norm,
                                              round_products)

    def plain(rounding=round_products):
        return correlation.correlation_volume_plain(ref, tgt, d, g, norm,
                                                    rounding)

    got, want = kernel(), plain()
    kind = "B" if round_products else "D"
    name = (f"correlation_volume {form} bf16 ({kind}'s rounding) "
            f"{variant(net)} {tuple(got.shape)}")
    if norm:
        err = compare_volume_ulps(name, got, want)
    else:
        bits = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        print(f"  {name}: {apart(got, want):.3e} of the entries differ from "
              f"the plain version in value, {bits} in bits (tolerance: "
              f"none)")
        require(torch.equal(got, want),
                f"{name}: kernel disagrees with its plain version")
        err = 0.0
    moved = apart(plain(not round_products), want)
    need = 1.0 - MIN_EXACT if norm else 0.0
    print(f"    with {'D' if round_products else 'B'}'s rounding "
          f"{moved:.3%} of the entries move (more than {need:.3%}, so that "
          f"it fails the criterion)")
    require(moved > need, "the comparison cannot see the rounding")
    # bf16 operands for B's gwc form; the normalised maps and D's sums are
    # fp32 arithmetic
    rate = BF16_FLOPS_PER_S if round_products and not norm \
        else FP32_FLOPS_PER_S
    bms, by = bound(nbytes(ref, tgt, got),
                    volume_flops(got.numel(), g, ref, norm), rate)
    row = {"name": "correlation_volume",
           "form": f"{form} bf16" + ("" if round_products
                                     else ", D's rounding"),
           "model": path or variant(net), "path": path,
           "form_key": correlation.volume_form(torch.bfloat16, norm,
                                               round_products),
           "route": "cuda",
           "source": "esmstereo_tpu_torch/csrc/correlation.cu",
           "replaces": ("esmstereo_tpu/ops/pallas/correlation.py:132"
                        if round_products else
                        "esmstereo_tpu/ops/pallas/correlation.py:249"),
           "input": list(shape), "output": list(got.shape),
           "max_abs_err": err, "ms": cuda_ms(kernel),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": None}
    return row, got


def stem_agg_unrounded(vol: torch.Tensor, stem, agg, approx: bool,
                       scale=None) -> torch.Tensor:
    """group_stem + agg as interpret mode computes them: the raw fp32
    weights (conv1's times ``scale``), BN after each fp32 sum, and no
    rounding but the output's, to bf16."""
    f = torch.nn.functional
    view = (1, -1, 1, 1, 1)
    y = vol.float()
    for i, blk in enumerate((stem, agg)):
        s_, t_ = blocks.bn_scale_shift(blk.bn)
        w = blk.conv.weight * (scale if i == 0 and scale is not None else 1.0)
        y = gelu(f.conv3d(y, w, padding=1) * s_.view(view) + t_.view(view),
                 approx)
    return y.to(torch.bfloat16)


def check_stem_agg_deploy(net, volume: torch.Tensor, form: str,
                          path: str | None, label: str | None = None
                          ) -> dict:
    """Kernel C's deploy form ``form`` (``"bf16"``, or ``"int8"`` on the
    quantised volume) on ``volume`` (fp32 or bf16, (1, G, D, H/v, W/v)) at
    the shapes of the served deploy path ``path`` (None for a form no path
    serves, named ``label``), with ``net``'s group_stem or corr_stem, tanh
    GELU, writing bf16, within 1 bf16 ulp of max(1, max|plain|) and
    bit-exact on all but at most 1% of the outputs. The form's step must be
    seen: the plain version without it (the bf16 form with fp32 operands,
    interpret mode's; the int8 form on the unquantised bf16 volume) moves
    more than 1% of the outputs and 10 times the kernel's share. At S's 12
    bins the
    volume's depths past 8 (the conv's partial depth chunk) must move the
    plain version by 10 tolerances. The yardstick is cuDNN's bf16
    ``conv3d`` x 2 (BN folded, no GELU) on the bf16 volume."""
    approx = True
    stem, agg = net.volume_stem, net.agg
    consts = fused_agg_stem.prepare_consts(stem, agg, low_precision=True)
    bf16 = torch.bfloat16
    if form == "int8":
        vin, scale = fused_agg_stem.quantize_volume(volume)
        c = fused_agg_stem.with_input_scale(consts, stem.conv.weight, scale)
        out = bf16
    else:
        vin, scale, c, out = volume.to(bf16), None, consts, None

    def kernel():
        return fused_agg_stem.stem_agg(vin, c, approx, out_dtype=out)

    def plain(v=vin):
        return fused_agg_stem.stem_agg_plain(v, c, approx, out_dtype=out)

    got, want = kernel(), plain()
    ci, co = vin.shape[1], got.shape[1]
    kind = "norm" if ci == 1 else "gwc"
    name = f"stem_agg {kind} {form} {variant(net)} {tuple(vin.shape)}"
    err = compare_ulps(name, got, want)
    near = apart(got, want)
    require(near <= 0.01, f"{name}: more than 1% of the outputs differ")
    tol = bf16_ulp(max(1.0, float(want.float().abs().max())))
    if form == "int8":
        step = "the int8 quantisation"
        blind = fused_agg_stem.stem_agg_plain(volume.to(bf16), consts, approx)
    else:
        step = "the operand rounding (fp32 operands)"
        blind = stem_agg_unrounded(vin, stem, agg, approx)
    moved = apart(blind, want)
    print(f"    without {step} {moved:.3%} of the outputs move, by up to "
          f"{float((blind.float() - want.float()).abs().max()):.3e} (more "
          f"than 1% and 10 times the kernel's {near:.3%})")
    require(moved > 0.01 and moved >= 10.0 * near,
            f"the comparison cannot see {step}")
    d = vin.shape[2]
    if d % 8:
        cut = vin.clone()
        cut[:, :, d - d % 8:] = 0
        gap = float((plain(cut).float() - want.float()).abs().max())
        print(f"    without the volume's depths {d - d % 8}..{d - 1} the "
              f"plain version moves {gap:.3e} (at least 10 tolerances: "
              f"{10 * tol:.3e})")
        require(gap >= 10 * tol, "the comparison cannot see the depths "
                f"{d - d % 8}..{d - 1}")
    vox = got.numel() // co
    bms, by = bound(nbytes(vin, *c.values(), got),
                    2 * vox * 27 * (ci * co + co * co), BF16_FLOPS_PER_S)
    folded = fused_agg_stem.prepare_consts(stem, agg)
    lib = {k: v.to(bf16) for k, v in folded.items()}
    vbf = volume.to(bf16)

    def library():
        f = torch.nn.functional
        y = f.conv3d(vbf, lib["w1"], lib["t1"], padding=1)
        return f.conv3d(y, lib["w2"], lib["t2"], padding=1)

    row = {"name": "stem_agg", "form": f"{kind} {form}",
           "model": label or path, "path": path, "form_key": form,
           "route": "cuda",
           "input": list(vin.shape),
           "source": "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
           "replaces": "esmstereo_tpu/ops/pallas/fused_agg_stem.py:162",
           "max_abs_err": err, "ms": cuda_ms(kernel),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": cuda_ms(library)}
    if form == "int8":
        row["quantize_ms"] = cuda_ms(
            lambda: fused_agg_stem.quantize_volume(volume))
    return row


# --- the switches' deploy forms (bf16; E, F, G, H, I) ------------------------

# A switch's deploy form against its plain version on the card: within
# SWITCH_ULPS bf16 ulps of max(1, max|plain|) and unequal on at most
# SWITCH_SHARE of the outputs (fp32 sums in another order than cuDNN's move a
# rounding to bf16 now and then, and a rounded intermediate carries it on:
# measured at most 0.5 ulp and 0.25% for E, F, G and H). Kernel I rounds 18
# chained steps' operands, its residual stream carries each moved rounding
# over a 7x7 neighbourhood, and its LayerNorm statistics are reduced in
# another order than torch's: measured 1 ulp on 8.5% of its outputs at the
# main path's shape, 4.8% at a ragged one (the fp32-operand version moves
# 68%), so it is held at MIXER_ULPS and MIXER_SHARE, and the plain version
# with any one of its rounding steps left out (``fused_mixer.ROUNDINGS``;
# each moves 38-62% of the outputs, measured on the CPU at both shapes)
# must fail that criterion against the kernel.
SWITCH_ULPS = 1.0
SWITCH_SHARE = 0.01
MIXER_ULPS = 2.0
MIXER_SHARE = 0.15


def compare_deploy(name: str, got: torch.Tensor, want: torch.Tensor,
                   unrounded: torch.Tensor | None = None,
                   ulps: float = SWITCH_ULPS,
                   share: float = SWITCH_SHARE) -> float:
    """``compare_ulps`` at ``ulps``, at most ``share`` of the outputs off by
    any bit; with ``unrounded`` (the plain version on fp32 operands,
    interpret mode's arithmetic, rounded to bf16 at the end) the form's
    operand rounding must be seen: that version moves more than 1% of the
    outputs and 5 times the kernel's share."""
    err = compare_ulps(name, got, want, ulps)
    near = apart(got, want)
    require(near <= share,
            f"{name}: {near:.3%} of the outputs differ (at most "
            f"{share:.0%})")
    if unrounded is not None:
        moved = apart(unrounded, want)
        print(f"    without the operand rounding (fp32 operands) {moved:.3%} "
              f"of the outputs move (more than 1% and 5 times the kernel's "
              f"{near:.3%})")
        require(moved > 0.01 and moved >= 5.0 * near,
                f"{name}: the comparison cannot see the operand rounding")
    return err


def require_seen_bf16(what: str, blind: torch.Tensor, want: torch.Tensor,
                      ulps: float = SWITCH_ULPS) -> None:
    """Fail unless ``blind`` (the plain deploy form without the step
    ``what`` names) lies at least 10 times ``ulps`` bf16 ulps of
    max|``want``| from ``want`` (the tolerance of ``compare_deploy`` without
    its floor of 1: the hourglass's outputs peak at 0.2-0.9)."""
    tol = ulps * bf16_ulp(float(want.float().abs().max()))
    gap = float((blind.float() - want.float()).abs().max())
    print(f"    without {what} the plain version moves {gap:.3e} (at least "
          f"10 tolerances: {10 * tol:.3e})")
    require(gap >= 10 * tol, f"the comparison cannot see {what}")


def check_volume_stem_agg_bf16(net, gen, path: str) -> dict:
    """Kernel E's bf16 form at the shapes of ``net``'s path: (1, 64, H/v,
    W/v) bf16 descriptors, ``net.num_bins`` bins, gwc (G = 32) or
    normalised G = 1 (corr_stem's weights x64, as in
    ``check_volume_stem_agg``), tanh GELU, against its plain version (B's
    plain bf16 volume, then C's plain bf16 form) and against kernels B and
    C's bf16 forms on the same inputs (the pair it replaces), each by
    ``compare_deploy``. Its peak memory over one call stays within its
    scratch (the normalised maps, in that form), the bf16 intermediate and
    the bf16 output, and in the gwc form below the bf16 volume it never
    allocates."""
    bf16 = torch.bfloat16
    shape = desc_shape(net)
    ref = torch.randn(shape, generator=gen).cuda().to(bf16)
    tgt = torch.randn(shape, generator=gen).cuda().to(bf16)
    d, g = net.num_bins, net.volume_groups
    norm = net.config.cost_volume == "norm_correlation"
    stem, agg = net.volume_stem, net.agg
    low = fused_agg_stem.prepare_consts(stem, agg, low_precision=True)
    fp = fused_agg_stem.prepare_consts(stem, agg)
    if norm:
        low = dict(low, w1=(low["w1"].float() * 64.0).to(bf16))
        fp = dict(fp, w1=fp["w1"] * 64.0)
    approx = True

    def kernel():
        return fused_agg_stem.volume_stem_agg(ref, tgt, low, d, g, approx,
                                              normalize=norm)

    def plain():
        return fused_agg_stem.volume_stem_agg_plain(ref, tgt, low, d, g,
                                                    approx, norm)

    def b_plus_c():
        vol = correlation.correlation_volume(ref, tgt, d, g, normalize=norm)
        return fused_agg_stem.stem_agg(vol, low, approx)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = kernel()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    volume_bytes = shape[0] * g * d * shape[2] * shape[3] * 2

    def block(n: int) -> int:
        return -(-n // 512) * 512 + (1 << 20 if n > 1 << 20 else 0)

    own_bytes = ((2 * block(ref.numel() * 4) if norm else 0)
                 + 2 * block(got.numel() * 2))
    print(f"  volume_stem_agg bf16 {variant(net)}: peak {peak / 1e6:.1f} MB "
          f"over one call (its scratch, intermediate and output: "
          f"{own_bytes / 1e6:.1f} MB); the bf16 volume it never allocates: "
          f"{volume_bytes / 1e6:.1f} MB")
    require(peak <= own_bytes, "volume_stem_agg bf16 allocated more than its "
            "scratch, intermediate and output")
    if not norm:
        require(peak < volume_bytes,
                "volume_stem_agg bf16 allocated as much as the volume")
    name = f"volume_stem_agg {'norm' if norm else 'gwc'} bf16 {variant(net)}"
    unrounded = fused_agg_stem.volume_stem_agg_plain(
        ref.float(), tgt.float(), fp, d, g, approx, norm).to(bf16)
    err = compare_deploy(f"{name} {tuple(got.shape)}", got, plain(),
                         unrounded)
    require_b_then_c(name, got, b_plus_c(), "bf16", g, d, *shape[2:],
                     4 if norm else 2)
    vox = got.numel() // got.shape[1]
    co = got.shape[1]
    flops = volume_flops(vox * g, g, ref, norm) + 2 * vox * 27 * (g * co
                                                                + co * co)
    bms, by = bound(nbytes(ref, tgt, *low.values(), got), flops,
                    BF16_FLOPS_PER_S)
    return {"name": "volume_stem_agg",
            "form": f"{'norm' if norm else 'gwc'} bf16", "model": path,
            "path": path, "form_key": "bf16", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_volume_agg.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_agg_stem.py:323",
            "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
            "library_ms": None, "b_plus_c_ms": cuda_ms(b_plus_c),
            "peak_mb": peak / 1e6}


# operations a value of each bf16 activation (jax.nn's formula; a
# function such as tanh counted as one)
ACTIVATION_OPS = {"gelu_tanh": 9, "gelu_erf": 4, "silu": 5, "sigmoid": 4,
                  "softmax": 5}


def activation_shapes(nets: dict) -> dict:
    """``{name: (path, shape)}``: the largest tensor each bf16 activation
    runs on, per op, in one forward of the per-op paths' models ``nets``
    (``{path: model}``) at the padded frame of the path; the erf GELU,
    which no deploy path runs (they take tanh), at the tanh GELU's."""
    seen = {}

    def record(path):
        def fn(x, name, dim=None):
            if x.numel() > math.prod(seen.get(name, (None, (0,)))[1]):
                seen[name] = (path, x.shape)
            return activations.activation_bf16(x, name, dim)
        return fn

    for path, net in nets.items():
        frame = KITTI_PADDED if path.startswith("C-") else PADDED
        pair = torch.zeros((2, *frame, 3), device="cuda")
        # the model's blocks reach the kernel through their module's
        # ``activations``; a stand-in there records each call's shape
        blocks.activations = types.SimpleNamespace(
            activation_bf16=record(path), gelu=activations.gelu)
        try:
            with bf16_per_op(), tanh_gelu():
                net(pair[:1], pair[1:])
        finally:
            blocks.activations = activations
    seen["gelu_erf"] = (None, seen["gelu_tanh"][1])
    return {k: (p, tuple(shape)) for k, (p, shape) in seen.items()}


def check_activation(name: str, path: str | None, shape: tuple,
                     gen) -> dict:
    """The bf16 activation ``name`` (``activations_bf16.cu``) at ``shape``,
    a served shape of ``path``: unit-normal values times 4, against its
    plain version on the card by ``compare_deploy`` (1 bf16 ulp, at most 1%
    of the values off); the share of values not bit-exact against the
    plain version on the CPU stated (CUDA's tanhf, expf and erfcf may
    differ from the CPU's by an fp32 ulp at a bf16 midpoint). Beside its
    time, torch's own function, which rounds once (``torch_ms``)."""
    bf16 = torch.bfloat16
    x = (torch.randn(shape, generator=gen) * 4.0).to(bf16).cuda()
    dim = 1 if name == "softmax" else None
    got = activations.activation_bf16(x, name, dim)
    want = activations.activation_bf16_plain(x, name, dim)
    label = f"activation_bf16 {name} {tuple(shape)}"
    err = compare_deploy(label, got, want)
    cpu = activations.activation_bf16_plain(x.cpu(), name, dim)
    print(f"    against the plain version on the CPU: "
          f"{apart(got.cpu(), cpu):.3e} of the values not bit-exact")
    once = {"gelu_tanh": lambda: torch.nn.functional.gelu(
                x, approximate="tanh"),
            "gelu_erf": lambda: torch.nn.functional.gelu(x),
            "silu": lambda: torch.nn.functional.silu(x),
            "sigmoid": lambda: torch.sigmoid(x),
            "softmax": lambda: torch.softmax(x, 1)}[name]
    bms, by = bound(2 * nbytes(x), ACTIVATION_OPS[name] * x.numel())
    return {"name": "activation_bf16", "form": name, "model": path or "none",
            "path": path, "form_key": name, "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/activations_bf16.cu",
            "replaces": "none (XLA's per-op bf16 roundings of jax.nn)",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: activations.activation_bf16(x, name, dim)),
            "plain_ms": cuda_ms(
                lambda: activations.activation_bf16_plain(x, name, dim)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "torch_ms": cuda_ms(once)}


def check_down_pairs_bf16(net, gen, path: str) -> tuple[dict, list]:
    """Kernel G's bf16 form at the hourglass's 3 down levels at the shapes
    of ``net``'s path (bf16 unit-normal inputs at each level, as
    ``check_down_pairs``), tanh GELU, by ``compare_deploy``; at S's 12
    channels the masked tile's channels must be seen. The yardstick is
    cuDNN's bf16 ``conv3d`` x 2 (BN folded, no GELU). Returns the row and
    the 3 output shapes."""
    agg = net.aggregation_out
    bf16 = torch.bfloat16
    levels, shapes = [], []
    shape = (1, 8, net.num_bins, *desc_shape(net)[2:])
    for k in (1, 2, 3):
        mods = (getattr(agg, f"conv{k}_0"), getattr(agg, f"conv{k}_1"))
        low = fused_hourglass.prepare_down_consts(*mods, low_precision=True)
        fp = fused_hourglass.prepare_down_consts(*mods)
        x = torch.randn(shape, generator=gen).cuda().to(bf16)
        got = fused_hourglass.down_pair(x, low, True)
        want = fused_hourglass.down_pair_plain(x, low, True)
        err = compare_deploy(
            f"down_pair bf16 {variant(net)} level {k} {tuple(x.shape)}", got,
            want, fused_hourglass.down_pair_plain(x.float(), fp,
                                                  True).to(bf16))
        ci, co = x.shape[1], got.shape[1]
        if co % 8:
            tail = co - co % 8
            require_seen_bf16(f"channels {tail}..{co - 1}",
                              fused_hourglass.down_pair_plain(
                                  x, tail_zeroed(low, ("wb", "sb", "tb"),
                                                 tail), True), want)
        vox = got.numel() // co
        bms, by = bound(nbytes(x, *low.values(), got),
                        2 * vox * co * 27 * (ci + co), BF16_FLOPS_PER_S)
        lib = {kk: v.to(bf16) for kk, v in fp.items()}

        def library(x=x, c=lib):
            y = torch.nn.functional.conv3d(x, c["wa"], c["ta"], stride=2,
                                           padding=1)
            return torch.nn.functional.conv3d(y, c["wb"], c["tb"], padding=1)

        levels.append({
            "level": k, "input": list(x.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda x=x, c=low: fused_hourglass.down_pair(
                x, c, True)),
            "plain_ms": cuda_ms(lambda x=x, c=low:
                                fused_hourglass.down_pair_plain(x, c, True)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)})
        shapes.append(tuple(got.shape))
        shape = tuple(got.shape)
    row = level_rows("down_pair",
                     "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
                     "esmstereo_tpu/attic/fused_hourglass.py:144", net, path,
                     levels)
    return dict(row, form="bf16", model=path, form_key="bf16"), shapes


def check_up_pairs_bf16(net, gen, downs: list, path: str) -> dict:
    """Kernel H's bf16 form at the hourglass's 2 up levels at the shapes of
    ``net``'s path (``downs``: G's output shapes), bf16 unit-normal src and
    skip, tanh GELU, by ``compare_deploy``; the transposed conv and, at S's
    12 channels, the masked tile's channels must be seen. The yardstick is
    cuDNN's bf16 transposed conv, ``cat`` and ``conv3d`` x 2."""
    agg = net.aggregation_out
    bf16 = torch.bfloat16
    levels = []
    for k, (names, src_shape, skip_shape) in enumerate(
            ((("conv3_up", "agg_0_0", "agg_0_1"), downs[2], downs[1]),
             (("conv2_up", "agg_1_0", "agg_1_1"), downs[1], downs[0])),
            start=1):
        mods = [getattr(agg, n) for n in names]
        low = fused_hourglass.prepare_up_consts(*mods, low_precision=True)
        fp = fused_hourglass.prepare_up_consts(*mods)
        src = torch.randn(src_shape, generator=gen).cuda().to(bf16)
        skip = torch.randn(skip_shape, generator=gen).cuda().to(bf16)
        got = fused_hourglass.up_pair(src, skip, low, True)
        want = fused_hourglass.up_pair_plain(src, skip, low, True)
        err = compare_deploy(
            f"up_pair bf16 {variant(net)} level {4 - k}->{3 - k} src "
            f"{tuple(src.shape)}", got, want,
            fused_hourglass.up_pair_plain(src.float(), skip.float(), fp,
                                          True).to(bf16))
        require_seen_bf16("the transposed conv", fused_hourglass.up_pair_plain(
            src, skip, tail_zeroed(low, ("wu", "su", "tu"), 0), True), want)
        ci, co = src.shape[1], got.shape[1]
        # the 1x1x1 conv's skip half, which the fused launch stages apart
        blind = dict(low, wc=low["wc"].clone())
        blind["wc"][:, co:] = 0.0
        require_seen_bf16("the 1x1x1 conv's skip half",
                          fused_hourglass.up_pair_plain(src, skip, blind,
                                                        True), want)
        if co % 8:
            tail = co - co % 8
            require_seen_bf16(f"channels {tail}..{co - 1}",
                              fused_hourglass.up_pair_plain(
                                  src, skip, tail_zeroed(
                                      low, ("w3", "s3", "t3"), tail), True),
                              want)
        vox = got.numel() // co
        flops = 2 * vox * co * (8 * ci + 2 * co + 27 * co)
        bms, by = bound(nbytes(src, skip, *low.values(), got), flops,
                        BF16_FLOPS_PER_S)
        lib = {kk: v.to(bf16) for kk, v in fp.items()}
        d2, h2, w2 = skip.shape[2:]

        def library(s=src, k_=skip, c=lib):
            f = torch.nn.functional
            up = f.conv_transpose3d(s, c["wu"], c["tu"], stride=2,
                                    padding=1)[:, :, :d2, :h2, :w2]
            z = f.conv3d(torch.cat([up, k_], dim=1), c["wc"], c["tc"])
            return f.conv3d(z, c["w3"], c["t3"], padding=1)

        levels.append({
            "level": f"{4 - k}->{3 - k}", "input": list(src.shape),
            "skip": list(skip.shape), "max_abs_err": err,
            "ms": cuda_ms(lambda s=src, k_=skip, c=low:
                          fused_hourglass.up_pair(s, k_, c, True)),
            "plain_ms": cuda_ms(lambda s=src, k_=skip, c=low:
                                fused_hourglass.up_pair_plain(s, k_, c,
                                                              True)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)})
    row = level_rows("up_pair", "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
                     "esmstereo_tpu/attic/fused_hourglass.py:453", net, path,
                     levels)
    return dict(row, form="bf16", model=path, form_key="bf16")


# --- the shared conv3d k3 p1 of C, E's agg, G and H, conv by conv ----------

def conv_cases(net) -> list:
    """(label, ConvBlock, input shape, stride) of each distinct conv3d k3 p1
    that kernels C, E's agg, G and H launch at ``net``'s main-path shapes
    (``conv3d_shapes``: group_stem or corr_stem and agg on the volume, then
    G's k3 s2 and k3 s1 at each level; H's k3 convs have the shapes of G's
    s1 convs at levels 1 and 2, E's agg that of agg); the label is the
    submodule's name without ``aggregation_out.``."""
    return [(name.split(".")[-1], net.get_submodule(name),
             (1, ci, d, h, w), stride)
            for name, ci, co, d, h, w, stride
            in conv3d_shapes(net.config, *PADDED)]


# the labels of kernel C's convs among ``conv_cases``
C_CONVS = ("group_stem", "corr_stem", "agg")


def conv_bf16_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain version of ``conv3d_bn_gelu_bf16`` writing bf16, tanh
    GELU: the fp32 sum of bf16 (or int8) operands, then the BN and GELU in
    fp32, rounded to bf16."""
    y = torch.nn.functional.conv3d(x.float(), w.float(), stride=stride,
                                   padding=1)
    return fused_hourglass.bn_gelu(y, scale, shift, True).to(torch.bfloat16)


def check_conv(label: str, block, shape: tuple, stride: int, form: str,
               gen, path: str | None, model: str) -> dict:
    """One conv3d k3 p1 of the shared kernel (``conv3d_bn_gelu`` in fp32,
    exact GELU; ``conv3d_bn_gelu_bf16`` on a bf16 or, with ``form`` int8,
    a quantised unit-normal input, tanh GELU, writing bf16) against its
    plain version (``F.conv3d`` + BN + GELU): fp32 within 1e-4 of max(1,
    max|plain|), the deploy forms by ``compare_deploy``. The yardstick is
    one cuDNN ``conv3d`` with the folded bias (bf16 for the deploy forms);
    the row gives the launch plan's tile, cluster size and blocks.
    ``path`` is the served path whose run counts its launches (None for a
    form no path serves)."""
    f = torch.nn.functional
    bf16 = torch.bfloat16
    xin = torch.randn(shape, generator=gen).cuda()
    wf, tf = blocks.fold_bn(block.conv.weight, block.bn)
    ci, co = shape[1], wf.shape[0]
    if form == "fp32":
        x, args = xin, (wf, tf)

        def kernel():
            return fused_hourglass.conv3d_bn_gelu(x, wf, tf, stride, False)

        def plain():
            return gelu(f.conv3d(x, wf, tf, stride=stride, padding=1), False)

        plan_form, lib, rate = "fp32", (xin, wf, tf), FP32_FLOPS_PER_S
    else:
        sc, sh = blocks.bn_scale_shift(block.bn)
        w = block.conv.weight.to(bf16)
        x = xin.to(bf16)
        if form == "int8":
            x, scale = fused_agg_stem.quantize_volume(x)
            w = (block.conv.weight.float() * scale).to(bf16)
        args = (w, sc, sh)

        def kernel():
            return fused_hourglass.conv3d_bn_gelu_bf16(x, w, sc, sh, bf16,
                                                       True, stride)

        def plain():
            return conv_bf16_plain(x, w, sc, sh, stride)

        plan_form = "int8_bf16" if form == "int8" else "bf16"
        lib = (xin.to(bf16), wf.to(bf16), tf.to(bf16))
        rate = BF16_FLOPS_PER_S
    plan = fused_hourglass.conv_plan(plan_form, ci, co, *shape[2:], stride)
    name = (f"conv3d {form} {model} {label} {ci} -> {co} s{stride} "
            f"{tuple(shape)}")
    got, want = kernel(), plain()
    if form == "fp32":
        # fp32 sums of 27 CI products in another order than cuDNN's
        err = compare(name, got, want, 1e-4)
    else:
        err = compare_deploy(name, got, want)
    print(f"    plan: tile {plan.tile}, {plan.groups} channel tiles of 8, "
          f"cluster {plan.cluster}, {plan.blocks} blocks, {plan.smem} B of "
          f"shared memory")
    bms, by = bound(nbytes(x, *args, got),
                    2 * got.numel() * ci * 27, rate)

    def library():
        return f.conv3d(lib[0], lib[1], lib[2], stride=stride, padding=1)

    return {"name": "conv3d_k3", "form": form, "model": model, "path": path,
            "conv": label, "shape_key": (plan_form, ci, co, *shape[2:],
                                         stride),
            "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_hourglass.cu",
            "replaces": ("esmstereo_tpu/ops/pallas/fused_agg_stem.py:162"
                         if label in C_CONVS else
                         "esmstereo_tpu/attic/fused_hourglass.py:144"),
            "input": list(shape), "stride": stride, "tile": list(plan.tile),
            "cluster": plan.cluster, "blocks": plan.blocks,
            "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(library)}


def check_convs(nets: list, gen) -> list:
    """``check_conv`` on every distinct conv shape of C, G and H at L, M
    and S, in fp32 and the deploy form, C's first conv also on the int8
    volume. ``nets``: (model, net, fp32 C path, fp32 G path, deploy C path,
    deploy G path) each; a shape already checked on an earlier net is not
    checked again (M-norm adds only corr_stem)."""
    rows, seen = [], set()
    for model, net, c_path, g_path, cd_path, gd_path in nets:
        for label, block, shape, stride in conv_cases(net):
            key = (shape, stride, block.conv.weight.shape[0])
            if key in seen:
                continue
            seen.add(key)
            c = label in C_CONVS
            rows.append(check_conv(label, block, shape, stride, "fp32", gen,
                                   c_path if c else g_path, model))
            rows.append(check_conv(label, block, shape, stride, "bf16", gen,
                                   cd_path if c else gd_path, model))
            if label in ("group_stem", "corr_stem"):
                rows.append(check_conv(
                    label, block, shape, stride, "int8", gen,
                    "L-deploy-int8" if model == "L" else None, model))
    return rows


def check_stems_deploy(net, gen, path: str) -> dict:
    """Kernel F's deploy form at the main path's shapes (both eyes, 544 x
    992, a unit-normal fp32 image, x4 at S's widths as in
    ``check_stems``), tanh GELU: both bf16 outputs by ``compare_deploy``;
    at S's widths stem_4's last 4 channels must be seen. The yardstick is
    cuDNN's bf16 ``conv2d`` x 4 (BN folded) with GELU and ReLU on the
    image in bf16."""
    bf16 = torch.bfloat16
    img = torch.randn((2, 3, *PADDED), generator=gen).cuda()
    low = fused_stems.prepare_consts(net.stem_2, net.stem_4,
                                     low_precision=True)
    fp = fused_stems.prepare_consts(net.stem_2, net.stem_4)
    c2, c4 = fused_stems.widths(low)
    if c4 % 16:
        img = img * 4.0
    got = fused_stems.stems(img, low, True)
    want = fused_stems.stems_plain(img, low, True)
    unrounded = fused_stems.stems_plain(img, fp, True)
    err = max(compare_deploy(f"stems deploy {name} {tuple(w.shape)}", g, w,
                             u.to(bf16))
              for name, g, w, u in zip(("stem_2", "stem_4"), got, want,
                                       unrounded))
    if c4 % 16:
        blind = {k: v.clone() for k, v in low.items()}
        blind["wc4"][..., c4 - 4:] = 0.0
        blind["tc4"][c4 - 4:] = 0.0
        require_seen_bf16(f"stem_4's channels {c4 - 4}..{c4 - 1}",
                          fused_stems.stems_plain(img, blind, True)[1],
                          want[1])
    b, _, h, w = img.shape
    px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    macs = px2 * c2 * (3 + c2) * 9 + px4 * c4 * (c2 + c4) * 9
    bms, by = bound(nbytes(img, *low.values(), *got), 2 * macs,
                    BF16_FLOPS_PER_S)
    lib_w = {k: v.permute(3, 0, 1, 2).contiguous().to(bf16)
             for k, v in fp.items() if v.ndim == 4}
    lib_t = {k: v.to(bf16) for k, v in fp.items() if v.ndim == 1}
    img_bf16 = img.to(bf16)

    def library():
        f = torch.nn.functional
        x = img_bf16
        for s in "24":
            x = gelu(f.conv2d(x, lib_w[f"wd{s}"], lib_t[f"td{s}"], stride=2,
                              padding=1), True)
            x = f.relu(f.conv2d(x, lib_w[f"wc{s}"], lib_t[f"tc{s}"],
                                padding=1))
        return x

    return {"name": "stems", "form": f"{c2}, {c4} deploy", "model": path,
            "path": path, "form_key": "bf16", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_stems.cu",
            "replaces": "esmstereo_tpu/ops/pallas/fused_stems.py:174",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_stems.stems(img, low, True)),
            "plain_ms": cuda_ms(lambda: fused_stems.stems_plain(img, low,
                                                                True)),
            "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(library)}


def require_each_rounding_seen(name: str, x: torch.Tensor, got: torch.Tensor,
                               consts: dict) -> None:
    """Fail unless the plain version of kernel I's bf16 form with any one
    of its rounding steps left out differs from the kernel's ``got`` on
    more than ``MIXER_SHARE`` of the outputs: the criterion the kernel
    meets would reject a kernel that skipped that step."""
    for step in fused_mixer.ROUNDINGS:
        moved = apart(got, fused_mixer.mixer_plain(x, consts, exact=(step,)))
        print(f"    {name} without the {step} rounding: {moved:.3%} of the "
              f"outputs differ from the kernel's (more than "
              f"{MIXER_SHARE:.0%})")
        require(moved > MIXER_SHARE,
                f"{name}: the comparison cannot see the {step} rounding")


def check_mixer_bf16(net, gen, path: str) -> dict:
    """Kernel I's bf16 form at the main path's shapes: a unit-normal bf16
    (1, 32, 136, 248) spx map, by ``compare_deploy`` at ``MIXER_ULPS`` and
    ``MIXER_SHARE``; each rounding step (``require_each_rounding_seen``)
    and block1.sm2's dw 7x7 must be seen, as in ``check_mixer``."""
    bf16 = torch.bfloat16
    x = torch.randn((1, 32, PADDED[0] // 4, PADDED[1] // 4),
                    generator=gen).cuda().to(bf16)
    stage = net.upsample_module.stage2x
    low = fused_mixer.prepare_consts(stage, low_precision=True)
    fp = fused_mixer.prepare_consts(stage)
    got = fused_mixer.mixer(x, low)
    want = fused_mixer.mixer_plain(x, low)
    err = compare_deploy(f"mixer bf16 {tuple(x.shape)}", got, want,
                         fused_mixer.mixer_plain(x.float(), fp).to(bf16),
                         MIXER_ULPS, MIXER_SHARE)
    require_each_rounding_seen(f"mixer bf16 {tuple(x.shape)}", x, got, low)
    blind = dict(low, packed=low["packed"].clone())
    fused_mixer.unpack(blind["packed"])["block1.sm2.dw_w"].zero_()
    require_seen_bf16("block1.sm2's dw 7x7", fused_mixer.mixer_plain(
        x, blind), want, MIXER_ULPS)
    px = x.shape[0] * x.shape[2] * x.shape[3]
    bms, by = bound(nbytes(x, low["packed"], got), 2 * px * MIXER_MACS,
                    BF16_FLOPS_PER_S)
    return {"name": "mixer", "form": "bf16", "model": path, "path": path,
            "form_key": "bf16", "route": "cuda",
            "source": "esmstereo_tpu_torch/csrc/fused_mixer.cu",
            "replaces": "esmstereo_tpu/attic/fused_mixer.py:212",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fused_mixer.mixer(x, low)),
            "plain_ms": cuda_ms(lambda: fused_mixer.mixer_plain(x, low)),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def stage_flops(consts: dict, shape) -> int:
    """Operations of kernel J's stage ``consts`` on an input of ``shape``
    (B, C, H, W): 2 per multiply-add of the expand (on the input grid), the
    depthwise conv, the SE MLP and the project, plus the gate's multiply
    and the residual's add per element."""
    b, _, h, w = shape
    ops = 0
    for blk in consts["blocks"]:
        mid, cout, k = blk["mid"], blk["cout"], blk["k"]
        ho = fused_stage.out_size(h, blk["stride"])
        wo = fused_stage.out_size(w, blk["stride"])
        macs = b * ho * wo * mid * (k * k + cout)
        if blk["kind"] == "ir":
            macs += b * h * w * blk["cin"] * mid
        if "se_w1" in blk:
            macs += b * 2 * mid * blk["se_w1"].shape[0]
            ops += b * ho * wo * mid
        if blk["residual"]:
            ops += b * ho * wo * cout
        ops += 2 * macs
        h, w = ho, wo
    return ops


def stage_blinds(x: torch.Tensor, consts: dict) -> dict:
    """Kernel J's plain version without each step a comparison must see:
    the SqueezeExcite gate (where the stage has one), the residual, and the
    stride-2 entry's row phase (the input shifted up one row, so that the
    entry samples the odd rows)."""
    blks = consts["blocks"]
    blinds = {"the residual": fused_stage.stage_reference(x, dict(
        consts, blocks=[dict(b, residual=False) for b in blks]))}
    if "se_w1" in blks[0]:
        blinds["the SE gate"] = fused_stage.stage_reference(x, dict(
            consts, blocks=[{k: t for k, t in b.items()
                             if not k.startswith("se_")} for b in blks]))
    if blks[0]["stride"] == 2:
        odd = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
        blinds["the even rows at the stride-2 entry (odd rows sampled)"] = \
            fused_stage.stage_reference(odd, consts)
    return blinds


def redrawn_pyramid(net, gen):
    """A copy of ``net``'s backbone with its weights redrawn by the CPU
    tests' rule (``fan_in_scaled_``): every BN gets a shift, which the init
    rule leaves at 0, and without which the depthwise conv's zero padding
    could not be told from the expand's act(shift) there."""
    pyr = copy.deepcopy(net.feature)
    fan_in_scaled_(pyr, gen)
    return pyr.eval()


def check_fused_stages(net, gen, path) -> dict:
    """Kernel J over stages 1-5 of ``net``'s backbone (efficientnet_b2 for
    L, mobilenetv2_100 for S) at the main path's shapes: kernel A's output
    on a seeded (2, 3, 544, 992) image (both eyes), on a redrawn copy of
    the backbone (``redrawn_pyramid``). Each stage's kernel and plain
    version take the plain chain's input; the kernel's own chain (each
    stage on the kernel's previous output) is held against the plain chain
    too, at every stage, within 1e-4 of max(1, max|plain|). Each stage's SE
    gate, residual and stride-2 row phase must each be seen
    (``stage_blinds``). The yardstick is the served unfused modules
    (``FeaturePyramid._run_stage``: cuDNN convs, BN, SE)."""
    pyr = redrawn_pyramid(net, gen)
    img = torch.randn((2, 3, *PADDED), generator=gen).cuda()
    x = chained = fused_backbone.fused_head(pyr, img)
    form = pyr.arch
    levels = []
    for si in range(1, 6):
        consts = prepare_stage_consts(pyr, si)
        got = fused_stage.fused_stage(x, consts)
        want = fused_stage.stage_reference(x, consts)
        # fp32 sums of up to 1248 products, and SE means over up to 34k
        # pixels, in another order than cuDNN's and torch's
        name = f"fused_stage {form} stage {si} {tuple(x.shape)}"
        err = compare(name, got, want, 1e-4)
        for what, blind in stage_blinds(x, consts).items():
            require_seen(what, blind, want, 1e-4)
        chained = fused_stage.fused_stage(chained, consts)
        chain_err = compare(f"{name}, chained on the kernel's own output",
                            chained, want, 1e-4)
        weights = [t for b in consts["blocks"]
                   for t in fused_stage.block_tensors(b)]
        bms, by = bound(nbytes(x, got, *weights),
                        stage_flops(consts, x.shape))
        levels.append({
            "level": si, "input": list(x.shape), "output": list(got.shape),
            "max_abs_err": max(err, chain_err),
            "ms": cuda_ms(lambda x=x, c=consts: fused_stage.fused_stage(x, c)),
            "plain_ms": cuda_ms(lambda x=x, c=consts:
                                fused_stage.stage_reference(x, c)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda x=x, si=si: pyr._run_stage(si, x))})
        x = want
    row = level_rows("fused_stage", "esmstereo_tpu_torch/csrc/fused_stage.cu",
                     "esmstereo_tpu/attic/fused_stage.py:270", net, path,
                     levels)
    row["form"] = form
    return row


def check_ragged_stages(model, s_gwc, gen) -> None:
    """Kernel J at small shapes that leave ragged 8 x 32 tiles and odd
    output sizes, batch 2: every stage 0-5 of both backbones (stage 0's
    depthwise-separable blocks too, with and without SE) on a redrawn
    copy of each backbone."""
    dev = torch.device("cuda")
    for net in (model, s_gwc):
        pyr = redrawn_pyramid(net, gen)
        cin = pyr.cfg.stem_chs
        for si, stage in enumerate(pyr.cfg.stages):
            size = (22, 74) if stage[0].stride == 2 else (11, 37)
            x = torch.randn((2, cin, *size), generator=gen).to(dev)
            consts = prepare_stage_consts(pyr, si)
            compare(f"fused_stage {pyr.arch} stage {si} {tuple(x.shape)}",
                    fused_stage.fused_stage(x, consts),
                    fused_stage.stage_reference(x, consts), 1e-4)
            cin = stage[-1].out_chs


def check_ragged_switches_deploy(model, m_norm, s_gwc, gen) -> None:
    """The switches' deploy forms at small shapes with ragged tiles on
    every axis and batch 2, by ``compare_deploy``, each step on its own
    input and the chain against the plain chain by ``compare_ulps``: E's
    gwc (``model``'s group_stem) and normalised G = 1 (``m_norm``'s
    corr_stem) forms at 13 and 48 bins (its volume + group_stem against the
    plain group_stem of the plain bf16 volume, its agg on its own
    group_stem output); G at L's, M's and S's widths (the k3 s1 conv's
    plain version on the kernel's intermediate); H there (its fused
    transposed + 1x1x1 launch against its plain steps, its k3 conv on that
    launch's own z); F at (32, 48) and (16, 24) (stem_4 on the kernel's
    own stem_2); I's seven phases (``check_mixer_steps``)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    for shape, d in (((2, 64, 7, 37), 13), ((2, 64, 5, 70), 48)):
        ref = torch.randn(shape, generator=gen).to(dev).to(bf16)
        tgt = torch.randn(shape, generator=gen).to(dev).to(bf16)
        for net, g, norm in ((model, 32, False), (m_norm, 1, True)):
            low = fused_agg_stem.prepare_consts(net.volume_stem, net.agg,
                                                low_precision=True)
            if norm:
                low = dict(low, w1=(low["w1"].float() * 64.0).to(bf16))
            name = (f"volume_stem_agg bf16 {'norm' if norm else 'gwc'} "
                    f"{shape}, D={d}")
            # each step on its own input, as G's convs below: an
            # intermediate at a bf16 midpoint rounds either way in the
            # kernel's and the plain version's summation orders
            mid, got = fused_agg_stem.volume_stem_agg(
                ref, tgt, low, d, g, True, normalize=norm, steps=True)
            vol = correlation.correlation_volume_plain(ref, tgt, d, g, norm)
            compare_deploy(f"{name}: its volume + group_stem", mid,
                           conv_bf16_plain(vol, low["w1"], low["s1"],
                                           low["t1"], 1))
            compare_deploy(f"{name}: its agg on its own group_stem", got,
                           conv_bf16_plain(mid, low["w2"], low["s2"],
                                           low["t2"], 1))
            compare_ulps(f"{name}: the chain", got,
                         fused_agg_stem.volume_stem_agg_plain(
                             ref, tgt, low, d, g, True, norm))
    for net, (c1, c2, c3) in ((model, (24, 40, 72)), (m_norm, (16, 24, 40)),
                              (s_gwc, (12, 16, 24))):
        agg = net.aggregation_out
        for k, shape in ((1, (2, 8, 13, 9, 21)), (2, (2, c1, 7, 5, 19)),
                         (3, (2, c2, 5, 7, 11))):
            low = fused_hourglass.prepare_down_consts(
                getattr(agg, f"conv{k}_0"), getattr(agg, f"conv{k}_1"),
                low_precision=True)
            x = torch.randn(shape, generator=gen).to(dev).to(bf16)
            name = f"down_pair bf16 level {k} {shape}"
            # each conv on its own input: the k3 s1 conv's plain version
            # takes the kernel's intermediate, as the kernel does (one
            # intermediate value that lies within an fp32 rounding of a
            # bf16 midpoint rounds either way in the two summation orders
            # and moves a few % of a ragged level's outputs)
            mid = fused_hourglass.conv3d_bn_gelu_bf16(
                x, low["wa"], low["sa"], low["ta"], bf16, True, stride=2)
            compare_deploy(f"{name}: its k3 s2 conv", mid,
                           conv_bf16_plain(x, low["wa"], low["sa"],
                                           low["ta"], 2))
            got = fused_hourglass.down_pair(x, low, True)
            compare_deploy(f"{name}: on its own k3 s2 output", got,
                           conv_bf16_plain(mid, low["wb"], low["sb"],
                                           low["tb"], 1))
            compare_ulps(f"{name}: the chain", got,
                         fused_hourglass.down_pair_plain(x, low, True))
        for names, src_shape, skip_shape in (
                (("conv3_up", "agg_0_0", "agg_0_1"), (2, c3, 3, 5, 6),
                 (2, c2, 5, 9, 11)),
                (("conv2_up", "agg_1_0", "agg_1_1"), (2, c2, 4, 4, 7),
                 (2, c1, 7, 7, 13))):
            low = fused_hourglass.prepare_up_consts(
                *(getattr(agg, n) for n in names), low_precision=True)
            src = torch.randn(src_shape, generator=gen).to(dev).to(bf16)
            skip = torch.randn(skip_shape, generator=gen).to(dev).to(bf16)
            name = f"up_pair bf16 src {src_shape} skip {skip_shape}"
            # each step on its own input, as G's above: the fused
            # transposed + 1x1x1 launch against its plain steps, the k3
            # conv on the launch's own z (the kernels repeat bit for bit)
            z = fused_hourglass.up_cat_bf16(src, skip, low, True)
            got = fused_hourglass.up_pair(src, skip, low, True)
            compare_deploy(f"{name}: its transposed + 1x1x1 conv", z,
                           fused_hourglass.up_cat_plain(src, skip, low, True))
            compare_deploy(f"{name}: its k3 conv on its own z", got,
                           conv_bf16_plain(z, low["w3"], low["s3"],
                                           low["t3"], 1))
            compare_ulps(f"{name}: the chain", got,
                         fused_hourglass.up_pair_plain(src, skip, low, True))
    img = torch.randn((2, 3, 44, 100), generator=gen).to(dev)
    for net in (model, s_gwc):
        low = fused_stems.prepare_consts(net.stem_2, net.stem_4,
                                         low_precision=True)
        s2, s4 = fused_stems.stems(img, low, True)
        want2, want4 = fused_stems.stems_plain(img, low, True)
        # stem_2 on the image, stem_4 on the kernel's own stem_2, the chain
        # by its max only
        compare_deploy(f"stems deploy stem_2 {tuple(s2.shape)}", s2, want2)
        compare_deploy(f"stems deploy stem_4 {tuple(s4.shape)} on its own "
                       f"stem_2", s4,
                       fused_stems.stem_block_plain(s2, low, "4", True))
        compare_ulps(f"stems deploy {tuple(s4.shape)}: the chain", s4, want4)
    x = torch.randn((2, 32, 11, 25), generator=gen).to(dev).to(bf16)
    low = fused_mixer.prepare_consts(model.upsample_module.stage2x,
                                     low_precision=True)
    check_mixer_steps("mixer bf16 (2, 32, 11, 25)", x, low)


def check_ragged_stem_up_tiles(model, m_norm, s_gwc, gen) -> None:
    """F's deploy kernel and H's fused transposed + 1x1x1 conv at shapes
    that fill none of their tiles, by ``compare_deploy``, each step on its
    own input and each chain by its max only (``compare_ulps``): H's crops
    not a multiple of its 32-column output tile, nor of its 2 or 4 rows
    and depths (L's widths at both tiles, M's and S's), its fused launch
    against ``up_cat_plain`` and its k3 conv on the launch's own z; F's
    StemBlocks at widths not a multiple of 16 (stem_4 at an odd one too),
    stem_4 against its plain version on the kernel's stem_2. The kernels
    repeat bit for bit, so the fused launch's own z is the one the level's
    k3 conv took."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    for net, up_levels in (
            (model, ((("conv3_up", "agg_0_0", "agg_0_1"), (2, 72, 3, 6, 13),
                      (2, 40, 5, 11, 25)),
                     (("conv2_up", "agg_1_0", "agg_1_1"), (1, 40, 9, 18, 35),
                      (1, 24, 17, 35, 70)))),
            (m_norm, ((("conv2_up", "agg_1_0", "agg_1_1"), (1, 24, 7, 11, 35),
                       (1, 16, 13, 21, 70)),)),
            (s_gwc, ((("conv2_up", "agg_1_0", "agg_1_1"), (2, 16, 4, 6, 13),
                      (2, 12, 7, 11, 25)),))):
        agg = net.aggregation_out
        for names, src_shape, skip_shape in up_levels:
            low = fused_hourglass.prepare_up_consts(
                *(getattr(agg, n) for n in names), low_precision=True)
            src = torch.randn(src_shape, generator=gen).to(dev).to(bf16)
            skip = torch.randn(skip_shape, generator=gen).to(dev).to(bf16)
            plan = fused_hourglass.up_plan(*src_shape[1:2],
                                           *skip_shape[1:2], *src_shape[2:],
                                           *skip_shape[2:])
            name = (f"up_pair bf16 src {src_shape} skip {skip_shape}, tile "
                    f"{plan.tile}")
            z = fused_hourglass.up_cat_bf16(src, skip, low, True)
            got = fused_hourglass.up_pair(src, skip, low, True)
            compare_deploy(f"{name}: its transposed + 1x1x1 conv", z,
                           fused_hourglass.up_cat_plain(src, skip, low, True))
            compare_deploy(f"{name}: its k3 conv on its own z", got,
                           conv_bf16_plain(z, low["w3"], low["s3"],
                                           low["t3"], 1))
            compare_ulps(f"{name}: the chain", got,
                         fused_hourglass.up_pair_plain(src, skip, low, True))
    for net in (model, s_gwc):
        low = fused_stems.prepare_consts(net.stem_2, net.stem_4,
                                         low_precision=True)
        for shape in ((2, 3, 36, 88), (1, 3, 52, 60)):
            img = torch.randn(shape, generator=gen).to(dev)
            s2, s4 = fused_stems.stems(img, low, True)
            want2, want4 = fused_stems.stems_plain(img, low, True)
            name = f"stems deploy {shape}"
            compare_deploy(f"{name}: stem_2 {tuple(s2.shape)}", s2, want2)
            compare_deploy(f"{name}: stem_4 {tuple(s4.shape)} on its own "
                           f"stem_2", s4,
                           fused_stems.stem_block_plain(s2, low, "4", True))
            compare_ulps(f"{name}: the chain", s4, want4)


def check_ragged_head_mixer(model, s_gwc, gen) -> None:
    """Kernels A and I at shapes that fill none of their tiles (A's 12 x 32
    output pixels, I's 3 x 32), batch 1 to 3: A in both forms (``model``:
    efficientnet_b2; ``s_gwc``: mobilenetv2_100, its stem scaled so that
    the ReLU6 clamps), fp32 within
    1e-4 of max(1, max|plain|) and bf16 out within 1 bf16 ulp; I in fp32
    (the whole call, and each of its seven phases on the kernel's own
    earlier ones, 1e-4 of max|plain|) and in bf16 (``check_mixer_steps``)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    forms = (fused_backbone.prepare_consts(model.feature),
             mobilenetv2_clamped(fused_backbone.prepare_consts(s_gwc.feature)))
    for shape in ((2, 3, 34, 66), (1, 3, 70, 130), (3, 3, 2, 4)):
        img = torch.randn(shape, generator=gen).to(dev)
        for consts in forms:
            name = f"fused_stage0 {fused_head.kernel_form(consts)} {shape}"
            want = fused_head.stage0_plain(img, consts)
            compare(name, fused_head.fused_stage0(img, consts), want, 1e-4)
            compare_ulps(f"{name} bf16 out",
                         fused_head.fused_stage0(img, consts, bf16),
                         want.to(bf16))
    stage = model.upsample_module.stage2x
    fp = fused_mixer.prepare_consts(stage)
    low = fused_mixer.prepare_consts(stage, low_precision=True)
    for shape in ((1, 32, 4, 33), (2, 32, 7, 45), (3, 32, 13, 97)):
        x = torch.randn(shape, generator=gen).to(dev)
        name = f"mixer {shape}"
        compare(name, fused_mixer.mixer(x, fp), fused_mixer.mixer_plain(x, fp),
                1e-4, floor=0.0)
        outs = fused_mixer.mixer(x, fp, steps=True)
        for step, (reads, writes) in enumerate(fused_mixer.STEPS, 1):
            args = {"x": x} if step == 1 else {
                n: outs[k - 1][n] for n, k in reads}
            want = fused_mixer.mixer_step_plain(step, fp, False, **args)
            for n in writes:
                compare(f"{name}: phase {step} ({n}) on its own inputs",
                        outs[step - 1][n], want[n], 1e-4, floor=0.0)
        if shape[0] > 1:
            check_mixer_steps(f"mixer bf16 {shape}", x.to(bf16), low)


def check_graph_capture(model, gen) -> None:
    """Kernels A's and I's cooperative launches (A's efficientnet_b2 form,
    fp32 and bf16 out; I in both forms) at the main path's shapes, captured
    into a CUDA graph: each replay must equal the eager call bit for bit (a
    launch that cannot be captured raises)."""
    img = torch.randn((2, 3, *PADDED), generator=gen).cuda()
    x = torch.randn((1, 32, PADDED[0] // 4, PADDED[1] // 4),
                    generator=gen).cuda()
    consts = fused_backbone.prepare_consts(model.feature)
    stage = model.upsample_module.stage2x
    fp = fused_mixer.prepare_consts(stage)
    low = fused_mixer.prepare_consts(stage, low_precision=True)
    calls = {f"fused_stage0 -> {o}": (
        lambda o=o: fused_head.fused_stage0(img, consts, o))
        for o in (torch.float32, torch.bfloat16)}
    calls["mixer fp32"] = lambda: fused_mixer.mixer(x, fp)
    calls["mixer bf16"] = lambda: fused_mixer.mixer(x.to(torch.bfloat16), low)
    for name, fn in calls.items():
        replay_equals_eager(name, fn)


def replay_equals_eager(name: str, fn) -> None:
    """``fn`` (returning a tensor or a tuple of them) captured into a CUDA
    graph: its replay must equal the eager call bit for bit (a launch that
    cannot be captured raises)."""
    def outs():
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    eager = outs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = outs()
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, eager))
    print(f"  {name}: captured into a CUDA graph; the replay "
          f"{'equals' if same else 'differs from'} the eager call bit for "
          f"bit")
    require(same, f"{name}: the graph's replay differs from the eager call")


def check_mixer_steps(name: str, x: torch.Tensor, low: dict) -> None:
    """Kernel I's bf16 form phase by phase (``fused_mixer.STEPS``): each
    of its seven phases against the plain step on the kernel's own
    earlier phases' outputs, by ``compare_deploy`` at ``MIXER_ULPS`` and
    ``MIXER_SHARE`` (the workspace's fp32 maps rounded to bf16, as the next
    layer reads them); the chain against ``mixer_plain`` by
    ``compare_ulps``; and each rounding step seen
    (``require_each_rounding_seen``)."""
    outs = fused_mixer.mixer(x, low, steps=True)
    for step, (reads, writes) in enumerate(fused_mixer.STEPS, 1):
        args = {"x": x} if step == 1 else {
            n: outs[k - 1][n] for n, k in reads}
        want = fused_mixer.mixer_step_plain(step, low, True, **args)
        for n in writes:
            compare_deploy(f"{name}: phase {step} ({n})",
                           outs[step - 1][n].to(torch.bfloat16),
                           want[n].to(torch.bfloat16), ulps=MIXER_ULPS,
                           share=MIXER_SHARE)
    got = fused_mixer.mixer(x, low)
    require(torch.equal(got, outs[-1]["y"]),
            f"{name}: the phases one by one differ from the whole call")
    compare_ulps(f"{name}: the chain", got, fused_mixer.mixer_plain(x, low),
                 MIXER_ULPS)
    require_each_rounding_seen(name, x, got, low)


def check_ragged_volume_stem_tiles(model, s_gwc, gen) -> None:
    """Kernel B's plans and F's fp32 form at ragged shapes: B in every
    form at W not a multiple of its block's columns (70 = 64 + 6, 33 = 32
    + 1) and D not of its thread rows (13, 7), under the plan of each of
    the source's blocks (``corr_plan``'s among them), each against its
    plain version at the
    tolerances of [3] (fp32 1e-5, bf16 gwc bit for bit, normalised bf16
    ``compare_volume_ulps``); F's fp32 form at both widths, its stem_4 at
    widths that are not a multiple of 8 (an odd one too), each StemBlock on
    its own input within 1e-4 of max|plain|. Then B at 200 shifts, whose
    window takes more than a block's default 48 KB of shared memory (the
    entry point opts in), after F's draws so that they do not move."""
    dev = torch.device("cuda")

    def volumes(shape, d):
        b, c, h, w = shape
        ref = torch.randn(shape, generator=gen).to(dev)
        tgt = torch.randn(shape, generator=gen).to(dev)
        for form, (g, norm) in FORMS.items():
            for blk in correlation.BLOCKS:
                plan = correlation.make_plan(b, c, g, h, w, d, norm, *blk)
                name = (f"correlation_volume {form} {shape}, D={d}, block "
                        f"{blk}")
                compare(name, correlation.volume_kernel(
                            ref, tgt, d, g, norm, True, plan),
                        correlation.correlation_volume_plain(ref, tgt, d, g,
                                                             norm),
                        1e-5, floor=0.0 if norm else 1.0, min_peak=1e-3)
                rb, tb = ref.bfloat16(), tgt.bfloat16()
                for rounding in (True, False):
                    got = correlation.volume_kernel(rb, tb, d, g, norm,
                                                    rounding, plan)
                    want = correlation.correlation_volume_plain(
                        rb, tb, d, g, norm, rounding)
                    bname = (f"{name} bf16 ({'B' if rounding else 'D'}'s "
                             f"rounding)")
                    if norm:
                        compare_volume_ulps(bname, got, want)
                    else:
                        print(f"  {bname}: {apart(got, want):.3e} of the "
                              f"entries differ (tolerance: none)")
                        require(torch.equal(got, want), bname)
    for shape, d in (((2, 64, 5, 70), 13), ((1, 64, 3, 33), 7)):
        volumes(shape, d)
    for net in (model, s_gwc):
        consts = fused_stems.prepare_consts(net.stem_2, net.stem_4)
        approx = blocks.GELU_APPROXIMATE
        for shape in ((2, 3, 36, 88), (1, 3, 44, 36), (1, 3, 52, 60)):
            img = torch.randn(shape, generator=gen).to(dev)
            if fused_stems.widths(consts)[1] % 16:
                img = img * 4.0
            s2, s4 = fused_stems.stems(img, consts, approx)
            name = f"stems fp32 {fused_stems.widths(consts)} {shape}"
            compare(f"{name}: stem_2 {tuple(s2.shape)}", s2,
                    fused_stems.stem_block_plain(img, consts, "2", approx),
                    1e-4, floor=0.0)
            compare(f"{name}: stem_4 {tuple(s4.shape)} on its own stem_2", s4,
                    fused_stems.stem_block_plain(s2, consts, "4", approx),
                    1e-4, floor=0.0)
    require(min(correlation.make_plan(1, 64, 32, 2, 230, 200, False,
                                      *blk).smem
                for blk in correlation.BLOCKS) > 48 * 1024,
            "B at 200 shifts: a window within the default shared memory")
    volumes((1, 64, 2, 230), 200)


def check_graph_capture_volume_stems(model, m_norm, s_gwc, gen) -> None:
    """Kernel B in every form a path serves (gwc at L in fp32 and bf16, the
    normalised G = 1 form at M in fp32 and bf16) and F's fp32 form at L's
    and S's widths, at the main path's shapes, captured into a CUDA graph:
    each replay must equal the eager call bit for bit."""
    calls = {}
    for net, g, norm in ((model, 32, False), (m_norm, 1, True)):
        shape = desc_shape(net)
        ref = torch.randn(shape, generator=gen).cuda()
        tgt = torch.randn(shape, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            r, t = ref.to(dt), tgt.to(dt)
            calls[f"correlation_volume {'norm' if norm else 'gwc'} "
                  f"{variant(net)} {dt}"] = (
                lambda r=r, t=t, d=net.num_bins, g=g, n=norm:
                (correlation.correlation_volume(r, t, d, g, n),))
    img = torch.randn((2, 3, *PADDED), generator=gen).cuda()
    for net in (model, s_gwc):
        consts = fused_stems.prepare_consts(net.stem_2, net.stem_4)
        calls[f"stems fp32 {fused_stems.widths(consts)}"] = (
            lambda c=consts: fused_stems.stems(img, c,
                                               blocks.GELU_APPROXIMATE))
    for name, fn in calls.items():
        replay_equals_eager(name, fn)


def check_ragged_deploy(model, m_norm, s_gwc, gen) -> None:
    """The deploy forms at small shapes with ragged tiles on every axis and
    batch 2: A's bf16 output in both forms (``model``: L's, ``s_gwc``: S's
    mobilenetv2), B's and D's bf16 forms (gwc, gwc_norm, norm) at 48 and at
    13 bins (an odd count: ``max_disp`` floors to any), C's bf16 form in
    both GELU forms and its int8 form writing bf16 and fp32, on 32 channels
    (L's group_stem) and on 1 (``m_norm``'s corr_stem)."""
    dev = torch.device("cuda")
    img = torch.randn((1, 3, 2 * 37, 2 * 45), generator=gen).to(dev)
    for net in (model, s_gwc):
        consts = fused_backbone.prepare_consts(net.feature)
        compare_ulps(f"fused_stage0 {net.config.backbone} bf16 out "
                     f"(1, 3, 74, 90)",
                     fused_head.fused_stage0(img, consts, torch.bfloat16),
                     fused_head.stage0_plain(img, consts).to(torch.bfloat16))
    ref = torch.randn((2, 64, 5, 70), generator=gen).to(dev).bfloat16()
    tgt = torch.randn((2, 64, 5, 70), generator=gen).to(dev).bfloat16()
    for form, (g, norm) in FORMS.items():
        for rounding in (True, False):
            for d in (48, 13):
                got = correlation.correlation_volume(ref, tgt, d, g, norm,
                                                     rounding)
                want = correlation.correlation_volume_plain(ref, tgt, d, g,
                                                            norm, rounding)
                name = (f"correlation_volume {form} bf16 "
                        f"({'B' if rounding else 'D'}'s rounding) "
                        f"(2, 64, 5, 70), D={d}")
                if norm:
                    compare_volume_ulps(name, got, want)
                else:
                    print(f"  {name}: {apart(got, want):.3e} of the entries "
                          f"differ (tolerance: none)")
                    require(torch.equal(got, want), name)
    for net, ci in ((model, 32), (m_norm, 1)):
        vol = torch.randn((2, ci, 13, 7, 37), generator=gen).to(dev)
        low = fused_agg_stem.prepare_consts(net.volume_stem, net.agg,
                                            low_precision=True)
        for approx in (False, True):
            v = vol.bfloat16()
            compare_ulps(f"stem_agg bf16 (2, {ci}, 13, 7, 37), tanh GELU "
                         f"{approx}",
                         fused_agg_stem.stem_agg(v, low, approx),
                         fused_agg_stem.stem_agg_plain(v, low, approx))
        q, scale = fused_agg_stem.quantize_volume(vol)
        c8 = fused_agg_stem.with_input_scale(low, net.volume_stem.conv.weight,
                                             scale)
        for out in (torch.bfloat16, torch.float32):
            compare_ulps(f"stem_agg int8 (2, {ci}, 13, 7, 37) -> {out}",
                         fused_agg_stem.stem_agg(q, c8, True, out_dtype=out),
                         fused_agg_stem.stem_agg_plain(q, c8, True,
                                                       out_dtype=out))


def check_deploy_against_cpu(gen, config: ESMStereoConfig,
                             confidence: bool = False,
                             ulp_slack: bool = True) -> None:
    """A deploy path (``config``, bf16, tanh GELU; with ``confidence`` the
    confidence model on it) on the card against the same path on the CPU
    (plain versions) on ``DEPLOY_DRAWS`` 128x256 pairs, beside the CPU
    path's own distance from the CPU in fp32 with exact GELU (the deploy
    numerics' own error), at the reference's init-rule weights (the
    confidence head's ``scale_bn3``, zero at init, gets scales in [0.75,
    1.25)). cuDNN's and the CPU's bf16 convs round at other places, so the
    card is held to no further from the CPU in bf16 than the deploy
    numerics are from fp32: in mean on every map, pooled over the pairs;
    in max on every pair, on the maps rounded to bf16 (the cost, cast to
    fp32 after its bf16 conv, and the confidence map) give or take 1 bf16
    ulp of max|CPU| with ``ulp_slack`` (the card and the CPU may round one
    value to neighbouring bf16 values, a whole ulp, where the fp32 model's
    own distance there can be under one), and on the fp32 disparity at
    cv8 and cv16, whose regression of the raw cost is continuous. The
    disparity is also held to tests/test_bf16.py:116-119's bounds (< 5% of
    pixels off by more than 1 px, a mean under 0.05 px over the others),
    or to the deploy numerics' own figures where those are larger, as
    tests/test_torch_deploy.py holds the CPU against JAX. cv4's top-2
    regression moves a pixel that flips by the gap between two peaks,
    which the draw sets: its disparity has no max bound, and its mean and
    flip share are held within ``CV4_MARGIN`` times the deploy numerics'
    own figures. The card runs cuDNN's deterministic algorithms, so that a
    draw's verdict repeats."""
    cls = ESMStereoConfidence if confidence else ESMStereo
    fp32 = dataclasses.replace(config, dtype="float32", volume_int8=False)
    ref = cls(fp32, device="cpu", seed=SEED + 2)
    if confidence:
        bn = ref.confidence_net.scale_bn3
        with torch.no_grad():
            bn.weight.copy_(0.75 + 0.5 * torch.rand(bn.weight.shape,
                                                    generator=gen))
    cpu = cls(config, device="cpu", seed=SEED + 2)
    gpu = cls(config, device="cuda", seed=SEED + 2)
    cpu.load_state_dict(ref.state_dict())
    gpu.load_state_dict(ref.state_dict())
    cv4 = config.cv_scale == 4
    margin = CV4_MARGIN if cv4 else 1.0
    disparities, means = [], {}
    for draw in range(DEPLOY_DRAWS):
        left = torch.randn((1, 128, 256, 3), generator=gen)
        right = torch.randn((1, 128, 256, 3), generator=gen)
        with torch.inference_mode():
            runs = [ref(left, right, capture_internals=True)]
            with tanh_gelu():
                runs.append(cpu(left, right, capture_internals=True))
                with deterministic_cudnn():
                    runs.append(gpu(left.cuda(), right.cuda(),
                                    capture_internals=True))
        outs = []
        for out, aux in runs:
            maps = dict(zip(("disparity", "confidence"), out))
            maps["cost"] = aux["cost"]
            outs.append({k: v.cpu() for k, v in maps.items()})
        r_map, c_map, g_map = outs
        maps = {k: (g_map[k], c_map[k], r_map[k]) for k in g_map}
        for key, (g, c, r) in maps.items():
            want_dtype = torch.bfloat16 if key == "confidence" \
                else torch.float32
            require(g.dtype == c.dtype == want_dtype and g.shape == c.shape
                    and torch.isfinite(g).all(),
                    f"{key} on the card: {g.dtype} {tuple(g.shape)} or "
                    "non-finite")
            card, own = (g.float() - c.float()).abs(), (c.float() - r).abs()
            print(f"  draw {draw} {key}: card against CPU bf16 max "
                  f"{float(card.max()):.3e} mean {float(card.mean()):.3e}; "
                  f"CPU bf16 against CPU fp32 max {float(own.max()):.3e} "
                  f"mean {float(own.mean()):.3e}")
            if key == "disparity":
                disparities.append((g, c, r))
                require(cv4 or card.max() <= own.max(),
                        "disparity: the card is further from the CPU than "
                        "the deploy numerics are from fp32 in max")
                continue
            slack = bf16_ulp(float(c.float().abs().max())) if ulp_slack \
                else 0.0
            require(card.max() <= own.max() + slack,
                    f"{key}: the card is further from the CPU than the "
                    "deploy numerics are from fp32 in max (bound "
                    f"{float(own.max()) + slack:.3e})")
            means.setdefault(key, []).append((float(card.mean()),
                                              float(own.mean())))
    for key, pairs in means.items():
        card, own = (sum(m) / len(pairs) for m in zip(*pairs))
        print(f"  {key} over {len(pairs)} draw(s): card against CPU bf16 "
              f"mean {card:.4e}, {card / own:.4f} times the deploy numerics' "
              f"own {own:.4e} (at most 1)")
        require(card <= own,
                f"{key}: the card is further from the CPU than the deploy "
                "numerics are from fp32 in mean")
    g, c, r = (torch.cat(maps) for maps in zip(*disparities))
    card, own = (g - c).abs(), (c - r).abs()
    ratio = float(card.mean()) / float(own.mean())
    print(f"  disparity over {len(disparities)} draw(s): card against CPU "
          f"bf16 mean {float(card.mean()):.4e}, {ratio:.4f} times the deploy "
          f"numerics' own {float(own.mean()):.4e} (at most {margin}); max "
          f"{float(card.max()):.3e} (own {float(own.max()):.3e})")
    require(card.mean() <= margin * own.mean(),
            "disparity: the card is further from the CPU than the deploy "
            "numerics are from fp32 in mean")

    def flips(a, b):
        diff = (a - b).abs()
        off = diff > 1.0
        return float(off.float().mean()), float(diff[~off].mean())

    (fl, sub), (own_fl, own_sub) = flips(g, c), flips(c, r)
    print(f"  disparity: {fl:.3%} of pixels off by more than 1 px, "
          f"{sub:.4f} px mean over the others (bounds: "
          f"{max(0.05, margin * own_fl):.3%}, {max(0.05, own_sub):.4f} px; "
          f"the deploy numerics' own {own_fl:.3%}, {own_sub:.4f} px)")
    require(fl < max(0.05, margin * own_fl) and sub < max(0.05, own_sub),
            "disparity: the card is outside the deploy bounds")


def check_ragged(model, m_norm, s_gwc, gen) -> None:
    """Each kernel against its plain version at small shapes that leave
    ragged tiles on every axis the main path leaves whole (kernel A's rows,
    kernel C's depth and rows; odd D, H and W for E, G, H and I; F's rows
    and columns at both levels), with batch 2 for B, C, E, F, G, H and
    I: ``model`` (L gwc) gives the weights of L's forms, ``m_norm`` (M
    norm-correlation) those of corr_stem and of M's hourglass widths,
    ``s_gwc`` (S) those of A's mobilenetv2 form, F at (16, 24) and S's
    hourglass widths."""
    dev = torch.device("cuda")
    img = torch.randn((1, 3, 2 * 37, 2 * 45), generator=gen).to(dev)
    for net in (model, s_gwc):
        consts = fused_backbone.prepare_consts(net.feature)
        compare(f"fused_stage0 {net.config.backbone} (1, 3, 74, 90)",
                fused_head.fused_stage0(img, consts),
                fused_head.stage0_plain(img, consts), 1e-4)
    ref = torch.randn((2, 64, 5, 70), generator=gen).to(dev)
    tgt = torch.randn((2, 64, 5, 70), generator=gen).to(dev)
    for form, (g, norm) in FORMS.items():
        for d in (48, 13):
            got = correlation.correlation_volume(ref, tgt, d, g,
                                                 normalize=norm)
            want = correlation.correlation_volume_plain(ref, tgt, d, g, norm)
            compare(f"correlation_volume {form} (2, 64, 5, 70), D={d}", got,
                    want, 1e-5, floor=0.0 if norm else 1.0, min_peak=1e-3)
    vol = torch.randn((2, 32, 13, 7, 37), generator=gen).to(dev)
    consts = fused_agg_stem.prepare_consts(model.group_stem, model.agg)
    for approx in (False, True):
        compare(f"stem_agg (2, 32, 13, 7, 37), tanh GELU {approx}",
                fused_agg_stem.stem_agg(vol, consts, approx),
                fused_agg_stem.stem_agg_plain(vol, consts, approx), 1e-4)
    vol1 = torch.randn((2, 1, 13, 7, 37), generator=gen).to(dev)
    nconsts = fused_agg_stem.prepare_consts(m_norm.volume_stem, m_norm.agg)
    compare("stem_agg (2, 1, 13, 7, 37)",
            fused_agg_stem.stem_agg(vol1, nconsts, False),
            fused_agg_stem.stem_agg_plain(vol1, nconsts, False), 1e-4)
    for shape, d, approx in (((2, 64, 7, 37), 13, False),
                             ((2, 64, 5, 70), 48, True)):
        ref = torch.randn(shape, generator=gen).to(dev)
        tgt = torch.randn(shape, generator=gen).to(dev)
        compare(f"volume_stem_agg {shape}, D={d}, tanh GELU {approx}",
                fused_agg_stem.volume_stem_agg(ref, tgt, consts, d, 32,
                                               approx),
                fused_agg_stem.volume_stem_agg_plain(ref, tgt, consts, d, 32,
                                                     approx), 1e-4)
        # the normalised G = 1 form, corr_stem's weights x64 as in [3]
        c64 = dict(nconsts, w1=nconsts["w1"] * 64.0)
        compare(f"volume_stem_agg norm {shape}, D={d}, tanh GELU {approx}",
                fused_agg_stem.volume_stem_agg(ref, tgt, c64, d, 1, approx,
                                               normalize=True),
                fused_agg_stem.volume_stem_agg_plain(ref, tgt, c64, d, 1,
                                                     approx, True), 1e-4,
                floor=0.0, min_peak=0.01)
    # the hourglass at L's widths (8 -> 24 -> 40 -> 72), M's (8 -> 16 ->
    # 24 -> 40) and S's (8 -> 12 -> 16 -> 24)
    for net, (c1, c2, c3) in ((model, (24, 40, 72)), (m_norm, (16, 24, 40)),
                              (s_gwc, (12, 16, 24))):
        agg = net.aggregation_out
        for k, shape, approx in ((1, (2, 8, 13, 9, 21), False),
                                 (2, (2, c1, 7, 5, 19), True),
                                 (3, (2, c2, 5, 7, 11), False)):
            consts = fused_hourglass.prepare_down_consts(
                getattr(agg, f"conv{k}_0"), getattr(agg, f"conv{k}_1"))
            x = torch.randn(shape, generator=gen).to(dev)
            compare(f"down_pair level {k} {shape}, tanh GELU {approx}",
                    fused_hourglass.down_pair(x, consts, approx),
                    fused_hourglass.down_pair_plain(x, consts, approx), 1e-4)
        for names, src_shape, skip_shape, approx in (
                (("conv3_up", "agg_0_0", "agg_0_1"), (2, c3, 3, 5, 6),
                 (2, c2, 5, 9, 11), False),
                (("conv2_up", "agg_1_0", "agg_1_1"), (2, c2, 4, 4, 7),
                 (2, c1, 7, 7, 13), True)):
            consts = fused_hourglass.prepare_up_consts(
                *(getattr(agg, n) for n in names))
            src = torch.randn(src_shape, generator=gen).to(dev)
            skip = torch.randn(skip_shape, generator=gen).to(dev)
            compare(f"up_pair src {src_shape} skip {skip_shape}, tanh GELU "
                    f"{approx}",
                    fused_hourglass.up_pair(src, skip, consts, approx),
                    fused_hourglass.up_pair_plain(src, skip, consts, approx),
                    1e-4)
    img = torch.randn((2, 3, 44, 100), generator=gen).to(dev)
    for net in (model, s_gwc):
        consts = fused_stems.prepare_consts(net.stem_2, net.stem_4)
        for approx in (False, True):
            got = fused_stems.stems(img, consts, approx)
            want = fused_stems.stems_plain(img, consts, approx)
            for name, g, w in zip(("stem_2", "stem_4"), got, want):
                compare(f"stems {name} {tuple(w.shape)}, tanh GELU "
                        f"{approx}", g, w, 1e-4)
    x = torch.randn((2, 32, 11, 25), generator=gen).to(dev)
    consts = fused_mixer.prepare_consts(model.upsample_module.stage2x)
    compare("mixer (2, 32, 11, 25)", fused_mixer.mixer(x, consts),
            fused_mixer.mixer_plain(x, consts), 1e-4)


def check_against_cpu(gen, config: ESMStereoConfig,
                      confidence: bool = False) -> None:
    """The model on the card (kernels) == the same weights on the CPU
    (plain versions) on a small pair, each map relative to its max|CPU|:
    the init rules leave some maps tiny (S's cost is ~1e-11 at 128x256,
    M's ~1e-5), where a tolerance with a floor of 1 would see nothing. At
    cv4 the hourglass output is sharpened (``conv1_up`` x 30) so that top-2
    regression rarely meets a near-tie, and the 1% exemption covers the
    pixels where it still does; cv8's and cv16's regression of the raw cost
    is continuous, so there disp_2 and the disparity must hold on every
    pixel. With ``confidence`` the model is the confidence model on
    ``config``, its ``scale_bn3`` (zero at init, which fixes the enlarged
    grid's scale at 1) gets scales in [0.75, 1.25), and its confidence map
    must hold on every pixel too."""
    cls = ESMStereoConfidence if confidence else ESMStereo
    cpu = cls(config, device="cpu", seed=SEED + 1)
    every_pixel = config.cv_scale != 4
    with torch.no_grad():
        if not every_pixel:
            cpu.aggregation_out.conv1_up.conv.weight.mul_(30.0)
        if confidence:
            bn = cpu.confidence_net.scale_bn3
            bn.weight.copy_(0.75 + 0.5 * torch.rand(bn.weight.shape,
                                                    generator=gen))
    gpu = cls(config, device="cuda", seed=SEED + 1)
    gpu.load_state_dict(cpu.state_dict())
    left = torch.randn((1, 128, 256, 3), generator=gen)
    right = torch.randn((1, 128, 256, 3), generator=gen)
    with torch.inference_mode():
        want, want_aux = cpu(left, right, capture_internals=True)
        got, got_aux = gpu(left.cuda(), right.cuda(), capture_internals=True)
    for key in ("match_left", "cost"):
        g, w = got_aux[key].cpu(), want_aux[key]
        peak = float(w.abs().max())
        require(peak > 0.0, f"{key}: all zero on the CPU")
        rel = float((g - w).abs().max()) / peak
        print(f"  {key}: max err {rel:.3e} of max|CPU| {peak:.3e} "
              f"(tolerance 1e-4)")
        require(rel < 1e-4, f"{key}: card disagrees with CPU")
    need = 1.0 if every_pixel else 0.99
    # disp_2 is the first upsampling stage's output: /2 of the input, /4
    # at cv16 (two x4 stages)
    up = 4 if config.cv_scale == 16 else 2
    maps = [("disp_2", got_aux["disp_2"], want_aux["disp_2"],
             (1, 128 // up, 256 // up)),
            ("disparity", got[0], want[0], (1, 128, 256))]
    if confidence:
        maps.append(("confidence", got[1], want[1], (1, 128, 256)))
    for key, g, w, shape in maps:
        g = g.cpu()
        require(g.shape == w.shape == shape and torch.isfinite(g).all(),
                f"{key} on the card: wrong shape or non-finite")
        peak = float(w.abs().max())
        require(peak > 0.0, f"{key}: all zero on the CPU")
        rel = (g - w).abs() / peak
        frac = float((rel < 1e-4).float().mean())
        print(f"  {key}: {frac:.4%} of pixels within 1e-4 of max|CPU| "
              f"{peak:.3e} (tolerance: at least {need:.0%}), max "
              f"{float(rel.max()):.3e}")
        require(frac >= need, f"{key}: card disagrees with CPU")


def fan_in_scaled_(model, gen: torch.Generator) -> None:
    """Redraw ``model``'s weights by the CPU tests' rule
    (``tests/test_torch_kernels.py::random_variables``): N(0, 2 / fan) for
    each conv weight, fan its elements per leading index; BN and layer-norm
    scales in [0.75, 1.25), biases and running means 0.1 N(0, 1), running
    variances in [0.5, 1.5)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                v = torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()
                                                           ) ** 0.5
            elif name.endswith("weight"):
                v = 0.75 + 0.5 * torch.rand(p.shape, generator=gen)
            else:
                v = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(v)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


@contextlib.contextmanager
def float64_plain():
    """While open, the wrappers (fp32 only, as the slice is) let float64
    CPU tensors through to their plain versions, and nothing else: the
    float64 reference of ``check_conditioning``. Their launch counts do not
    move."""
    mods = (correlation, fused_agg_stem, fused_head, fused_hourglass,
            fused_mixer, fused_stems)
    saved = {m: m.on_cuda for m in mods}

    def plain_only(what, *tensors, dtypes=None):
        require(all(t.device.type == "cpu" and t.dtype == torch.float64
                    for t in tensors), f"{what}: the float64 reference "
                "takes float64 CPU tensors only")
        return False

    try:
        for m in mods:
            m.on_cuda = plain_only
        yield
    finally:
        for m, fn in saved.items():
            m.on_cuda = fn


def check_conditioning(name: str, config: ESMStereoConfig,
                       draws=(0, 1, 2, 3)) -> None:
    """The card under fan-in-scaled weights (``fan_in_scaled_``), where the
    comparison of [4] with the CPU in fp32 does not hold: the model on the
    card, and the same weights on the CPU in fp32, each against the CPU in
    float64 (plain versions) on a 128x256 pair, for each draw of weights.
    The fp32 CPU's own distance from float64 says how far these weights
    amplify fp32 rounding; the card must come within 10 times that (or 1e-5
    of max|float64|, where the CPU is nearer) on match_left and cost, and at
    cv8 and cv16 (continuous regression) on disp_2 and the disparity too.
    Kernels A and F (the kernels upstream of match_left; F where
    ``config`` has ``fuse_stems``) are also held against their plain
    versions on the card at these weights, at 1e-4 of max(1, max|plain|)."""
    keys = ["match_left", "cost"]
    if config.cv_scale != 4:
        keys += ["disp_2", "disparity"]
    for draw in draws:
        wgen = torch.Generator().manual_seed(SEED + 100 + draw)
        cpu = ESMStereo(config, device="cpu", seed=SEED)
        fan_in_scaled_(cpu, wgen)
        gpu = ESMStereo(config, device="cuda", seed=SEED)
        gpu.load_state_dict(cpu.state_dict())
        f64 = ESMStereo(config, device="cpu", seed=SEED)
        f64.load_state_dict(cpu.state_dict())
        f64.double()
        left = torch.randn((1, 128, 256, 3), generator=wgen)
        right = torch.randn((1, 128, 256, 3), generator=wgen)
        with torch.inference_mode():
            maps = {}
            for tag, net, dev, dt in (("card", gpu, "cuda", torch.float32),
                                      ("cpu", cpu, "cpu", torch.float32)):
                disp, aux = net(left.to(dev), right.to(dev),
                                capture_internals=True)
                maps[tag] = dict(aux, disparity=disp[0])
            with float64_plain():
                disp, aux = f64(left.double(), right.double(),
                                capture_internals=True)
            maps["f64"] = dict(aux, disparity=disp[0])
            img = torch.randn((2, 3, 128, 256), generator=wgen).cuda()
            consts = fused_backbone.prepare_consts(gpu.feature)
            compare(f"{name} draw {draw}: fused_stage0",
                    fused_head.fused_stage0(img, consts),
                    fused_head.stage0_plain(img, consts), 1e-4)
            if config.fuse_stems:
                sc = fused_stems.prepare_consts(gpu.stem_2, gpu.stem_4)
                approx = blocks.GELU_APPROXIMATE
                for part, g, w in zip(("stem_2", "stem_4"),
                                      fused_stems.stems(img, sc, approx),
                                      fused_stems.stems_plain(img, sc,
                                                              approx)):
                    compare(f"{name} draw {draw}: stems {part}", g, w, 1e-4)
        for key in keys:
            want = maps["f64"][key]
            peak = float(want.abs().max())
            require(peak > 0.0, f"{key}: all zero in float64")
            err = {tag: float((maps[tag][key].cpu().double() - want).abs()
                              .max()) / peak for tag in ("card", "cpu")}
            card_cpu = float((maps["card"][key].cpu() - maps["cpu"][key])
                             .abs().max()) / peak
            print(f"  {name} draw {draw} {key}: card {err['card']:.3e}, CPU "
                  f"fp32 {err['cpu']:.3e} of max|float64| {peak:.3e} from "
                  f"float64; card against CPU fp32 {card_cpu:.3e}")
            require(err["card"] <= max(10.0 * err["cpu"], 1e-5),
                    f"{name} {key}: the card is further from float64 than "
                    f"the fp32 CPU's rounding explains")


def serve(model, rng: np.random.Generator, frame=FRAME) -> list:
    """Answer ``REQUESTS`` uint8 pairs of ``frame``; check and print each
    disparity (and confidence map, from the confidence model). Returns
    each request's ms."""
    runner = InferenceRunner(model)
    times = []
    for i in range(REQUESTS):
        left = rng.integers(0, 256, (*frame, 3), dtype=np.uint8)
        right = np.roll(left, -8, axis=1)          # a constant 8-px shift
        out, dt = runner(left, right)
        maps = out if isinstance(out, tuple) else (out,)
        for name, m in zip(("disparity", "confidence"), maps):
            require(m.shape == frame, f"request {i}: {name} {m.shape}")
            require(np.isfinite(m).all(), f"request {i}: non-finite {name}")
        if len(maps) == 2:
            require(((maps[1] >= 0) & (maps[1] <= 1)).all(),
                    f"request {i}: confidence outside [0, 1]")
        ranges = ", ".join(f"{name} {m.min():.3f} .. {m.max():.3f}"
                           for name, m in zip(("disparity", "confidence"),
                                              maps))
        print(f"  request {i}: {frame[0]}x{frame[1]} -> {len(maps)} map(s) "
              f"{maps[0].shape}, {dt * 1e3:.2f} ms ({ranges})")
        times.append(dt * 1e3)
    return times


# [6]: the SceneFlow recipe (tools/train_sceneflow.py:24,44; the JAX
# loop's AdamW at lr 1e-3, train/loop.py:32-35): batch 4 of 256x512 crops
TRAIN_BATCH = 4
TRAIN_CROP = (256, 512)
TRAIN_BATCHES = 8
OVERFIT_STEPS = 8
OVERFIT_WARMUP = 2
# S's card step against the CPU (batch 2, 64x128)
S_STEP_BATCH = 2
S_STEP_CROP = (64, 128)


def check_training_run(model) -> None:
    """[6] 1 and 3: ``run_training`` on ``model`` (L), one epoch of
    ``TRAIN_BATCHES`` synthetic scene batches, a checkpoint that
    ``latest_checkpoint`` finds, no kernel launched in the training steps;
    then 4: a resume from that checkpoint into another model gives its
    parameters, statistics and optimizer state bit for bit."""
    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        loader = DataLoader(SceneDataset(TRAIN_BATCH * TRAIN_BATCHES,
                                         *TRAIN_CROP),
                            TRAIN_BATCH, num_workers=4, seed=SEED)
        cfg = TrainLoopConfig(epochs=1, logdir=logdir)
        reset_launches()
        out = run_training(model, cfg, loader, None,
                           log_fn=lambda line: print(f"  {line}"))
        torch.cuda.synchronize()
        moved = {k: fn.launches for k, fn in wrappers().items()
                 if fn.launches}
        require(not moved, f"kernels launched in the training steps: {moved}")
        state = out["state"]
        require(state.step == TRAIN_BATCHES,
                f"run_training took {state.step} steps, not {TRAIN_BATCHES}")
        path = checkpoints.latest_checkpoint(logdir)
        require(path == checkpoints.checkpoint_path(logdir, 0),
                f"latest_checkpoint found {path}")
        other = ESMStereo(device="cuda", seed=SEED + 6)
        fresh = create_train_state(other, cfg.optimizer, lr_schedule_fn(
            cfg.lr, cfg.lrepochs, TRAIN_BATCHES))
        fresh, next_epoch = checkpoints.restore_checkpoint(path, fresh)
        require(next_epoch == 1 and fresh.step == state.step,
                f"resume: epoch {next_epoch}, step {fresh.step}")
        for (k, a), b in zip(model.state_dict().items(),
                             other.state_dict().values()):
            require(torch.equal(a, b), f"resume: {k} differs")
        want, got = state.optimizer.state_dict(), \
            fresh.optimizer.state_dict()
        require(want["param_groups"] == got["param_groups"]
                and len(want["state"]) == len(got["state"]) == len(
                    list(model.parameters())),
                "resume: optimizer groups or state count differ")
        for i, entry in want["state"].items():
            for k, v in entry.items():
                require(torch.equal(v, got["state"][i][k]),
                        f"resume: optimizer {k} of parameter {i} differs")
        print(f"  checkpoint {path.rsplit('/', 1)[1]}: found by "
              f"latest_checkpoint; resumed bit for bit ({len(want['state'])} "
              f"parameters' exp_avg, exp_avg_sq, step; step {fresh.step})")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def check_overfit() -> dict:
    """[6] 2: a fresh L, ``OVERFIT_STEPS`` train steps on one repeated
    batch of the recipe: every loss finite and the last below 0.8 x the
    first (the criterion of tests/test_train_step.py:35-39); each step
    timed by CUDA events (its median after ``OVERFIT_WARMUP``), the peak
    device memory, and no kernel launched."""
    model = ESMStereo(device="cuda", seed=SEED + 7)
    state = create_train_state(model, "adamw", lr_schedule_fn(
        1e-3, TrainLoopConfig.lrepochs, TRAIN_BATCHES))
    step = make_train_step(model)
    batch = make_scene_batch(np.random.default_rng(SEED + 7), TRAIN_BATCH,
                             *TRAIN_CROP)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(OVERFIT_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses: {', '.join(f'{v:.4f}' for v in losses)}")
    require(all(math.isfinite(v) for v in losses), "non-finite loss")
    require(losses[-1] < 0.8 * losses[0],
            f"loss {losses[-1]:.4f} after {OVERFIT_STEPS} steps is not below "
            f"0.8 x the first {losses[0]:.4f}")
    require(all(fn.launches == 0 for fn in wrappers().values()),
            "a kernel launched in a train step")
    step_ms = float(np.median(times[OVERFIT_WARMUP:]))
    print(f"  train step (L, fp32, TF32 off, batch {TRAIN_BATCH} x "
          f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]}): median {step_ms:.2f} ms over "
          f"steps {OVERFIT_WARMUP}-{OVERFIT_STEPS - 1} (each: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms); peak device memory "
          f"{peak / 2**30:.3f} GiB; 0 kernel launches a step")
    return {"step_ms": step_ms, "peak_bytes": peak, "losses": losses}


def _s_step(device: str, dtype: torch.dtype, batch: dict):
    """One ``make_train_step`` step of S (seeded init weights) in
    ``dtype`` on ``device``: (gradients, running statistics), float64 on
    the CPU."""
    model = ESMStereo(S, device=device, seed=SEED + 8).to(dtype)
    state = create_train_state(model, "adamw", lambda step: 1e-3)
    cast = (lambda x: torch.from_numpy(x).to(device, dtype))
    b = {k: [cast(x) for x in v] if isinstance(v, list) else cast(v)
         for k, v in batch.items()}
    with deterministic_cudnn():
        make_train_step(model)(state, b)
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    stats = {k: t.detach().cpu().double() for k, t in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return grads, stats


def _grad_errors(got: dict, want: dict) -> dict:
    """Per tensor: max|got - want| over max(max|want|, 1e-9 of the largest
    tensor's max|want|); the floor gives a gradient that is zero by
    construction but for rounding (a BatchNorm shift whose output only
    feeds training-mode BatchNorms) a scale."""
    floor = 1e-9 * max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), floor) for k, w in want.items()}


def check_s_step_against_cpu() -> None:
    """[6] 5: one train step of S at 64x128, batch 2, on the card and on
    the CPU from the same weights and batch, cuDNN deterministic. In
    float64 (the same function: the training forward's batch statistics
    amplify fp32 rounding, so that the CPU's own fp32 gradients lie up to
    5% of a tensor's max|g| from float64 on some tensors at these
    weights) every parameter's gradient within 1e-4 of its max|g| and the
    running statistics within 1e-4 of max(1, max|CPU|); in fp32 the
    card's worst tensor no further from the CPU's float64 step than 10
    times the CPU fp32 step's own worst."""
    batch = make_scene_batch(np.random.default_rng(SEED + 8), S_STEP_BATCH,
                             *S_STEP_CROP)
    want_g, want_s = _s_step("cpu", torch.float64, batch)
    got_g, got_s = _s_step("cuda", torch.float64, batch)
    g_err = _grad_errors(got_g, want_g)
    s_err = {k: float((got_s[k] - w).abs().max()) / max(
        1.0, float(w.abs().max())) for k, w in want_s.items()}
    worst_g = max(g_err, key=g_err.get)
    worst_s = max(s_err, key=s_err.get)
    print(f"  S float64 step: worst gradient {worst_g} "
          f"{g_err[worst_g]:.3e} of its max|g| (tolerance 1e-4, {len(g_err)} "
          f"tensors); worst running statistic {worst_s} "
          f"{s_err[worst_s]:.3e} (tolerance 1e-4, {len(s_err)} buffers)")
    require(g_err[worst_g] <= 1e-4, "S's float64 gradients on the card "
            "disagree with the CPU's")
    require(s_err[worst_s] <= 1e-4, "S's running statistics on the card "
            "disagree with the CPU's")
    card = max(_grad_errors(_s_step("cuda", torch.float32, batch)[0],
                            want_g).values())
    cpu = max(_grad_errors(_s_step("cpu", torch.float32, batch)[0],
                           want_g).values())
    print(f"  S fp32 step against the CPU's float64 step: card's worst "
          f"tensor {card:.3e}, the CPU fp32's own {cpu:.3e} of max|g| "
          f"(bound 10x the CPU's)")
    require(card <= 10.0 * cpu, "S's fp32 gradients on the card are "
            "further from float64 than the CPU's fp32 rounding explains")


def check_autograd_refusal(model) -> None:
    """[6] the wrappers refuse autograd on the card: kernels B and C raise
    ``RuntimeError`` on an input that requires grad under grad mode and
    launch nothing; under ``torch.no_grad()`` the same calls launch."""
    d = model.num_bins
    desc = torch.randn((1, 64, 16, 32), device="cuda", requires_grad=True)
    vol = torch.randn((1, 32, d, 16, 32), device="cuda", requires_grad=True)
    with torch.no_grad():
        consts = fused_agg_stem.prepare_consts(model.group_stem, model.agg)
    calls = {"correlation_volume": lambda: correlation.correlation_volume(
                 desc, desc.detach(), d, 32),
             "stem_agg": lambda: fused_agg_stem.stem_agg(vol, consts, False)}
    kernels = wrappers()
    for name, call in calls.items():
        reset_launches()
        try:
            call()
        except RuntimeError as e:
            require("eval-only" in str(e), f"{name} raised {e}")
        else:
            raise RuntimeError(f"chip_smoke: {name} launched on an input "
                               f"that requires grad")
        require(kernels[name].launches == 0, f"{name} counted a launch")
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        require(kernels[name].launches == 1,
                f"{name} did not launch under no_grad")
        print(f"  {name}: raises under autograd, launches under no_grad")


def check_served_after_training(model) -> None:
    """[6] 6: the trained L in eval mode serves ``REQUESTS`` requests
    through ``InferenceRunner``, each launching kernels A, B and C once and
    no other kernel (folded constants recomputed from the trained weights,
    not the ones memoised before training), and on a 128x256 pair the
    card's match_left and cost within 1e-4 of max|CPU| of the same trained
    weights on the CPU (plain versions), the disparity finite."""
    reset_launches()
    serve(model, np.random.default_rng(SEED + 9))
    torch.cuda.synchronize()
    want = {"fused_stage0": REQUESTS, "correlation_volume": REQUESTS,
            "stem_agg": REQUESTS}
    got = {k: fn.launches for k, fn in wrappers().items() if fn.launches}
    require(got == want, f"after training the eval path launched {got} "
            f"(want {want})")
    cpu = ESMStereo(device="cpu", seed=SEED)
    cpu.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(SEED + 9)
    left = torch.randn((1, 128, 256, 3), generator=gen)
    right = torch.randn((1, 128, 256, 3), generator=gen)
    with torch.inference_mode():
        want_d, want_aux = cpu(left, right, capture_internals=True)
        got_d, got_aux = model(left.cuda(), right.cuda(),
                               capture_internals=True)
    for key in ("match_left", "cost"):
        g, w = got_aux[key].cpu(), want_aux[key]
        peak = float(w.abs().max())
        rel = float((g - w).abs().max()) / peak
        print(f"  trained {key}: max err {rel:.3e} of max|CPU| {peak:.3e} "
              f"(tolerance 1e-4)")
        require(peak > 0.0 and rel < 1e-4,
                f"trained {key}: the card disagrees with the CPU")
    d = got_d[0].cpu()
    share = float(((d - want_d[0]).abs() / float(want_d[0].abs().max())
                   < 1e-4).float().mean())
    require(d.shape == (1, 128, 256) and torch.isfinite(d).all(),
            "trained disparity: wrong shape or non-finite")
    print(f"  trained disparity: {share:.4f} of pixels within 1e-4 of "
          f"max|CPU| (cv4's top-2 regression flips near-ties; not bound)")


def check_training() -> dict:
    """[6] train: ESMStereo-L at full width in fp32 (TF32 off) on the
    SceneFlow recipe, synthetic scenes from ``make_scene_batch``, weights
    from the seeded init; S's train step against the CPU; the wrappers'
    refusal of autograd."""
    model = ESMStereo(device="cuda", seed=SEED)
    # one request first, so that the eval's folded constants are memoised
    # from the initial weights before training changes them
    InferenceRunner(model)(*[np.random.default_rng(SEED).integers(
        0, 256, (*FRAME, 3), dtype=np.uint8)] * 2)
    check_training_run(model)
    perf = check_overfit()
    check_s_step_against_cpu()
    check_autograd_refusal(model)
    check_served_after_training(model)
    return perf


# [7]: the entry points on the card, on synthetic trees in each dataset's
# layout written by the port's own writers: make_scene_batch scenes as
# uint8 PNG pairs, their disparities as PFM or KITTI's uint16 PNG
SF_PAIRS = 4                    # the SceneFlow list tree, at FRAME
EVAL_CROP = (512, 960)          # train_sceneflow's test crop
KITTI_PAIRS = 2                 # KITTI-2015 training/ and testing/ trees
MID_FRAME = (496, 718)          # MiddEval3 trainingQ's Adirondack
ETH3D_FRAME = (489, 941)        # ETH3D two-view delivery_area_1l
TREE_DISPARITIES = (4, 96)
S_FLAGS = ["--backbone", "mobilenetv2_100", "--cv_scale", "16"]
# the eval path's kernels (A, B, C), as [5] counts them
EVAL_KERNELS = ("fused_stage0", "correlation_volume", "stem_agg")
# an EPE figure as the CLIs print it ("EPE 1.234", "EPE = 1.234")
EPE_RE = re.compile(r"EPE\s*=?\s*([-+0-9.eE]+|nan|inf)")


def scene_pairs(rng: np.random.Generator, n: int, frame) -> list:
    """``n`` ``make_scene_batch`` scenes at ``frame``: (left uint8, right
    uint8, disparity float32) each."""
    b = make_scene_batch(rng, n, *frame, disp_range=TREE_DISPARITIES,
                         pyramid=False)

    def u8(x):
        return np.round(denormalize_image(x) * 255).astype(np.uint8)

    return [(u8(b["left"][i]), u8(b["right"][i]), b["disparity"][i])
            for i in range(n)]


def write_file(path: str, data: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".pfm"):
        pfm_imwrite(path, data)
    else:
        png.write_png(path, data)


def write_trees(root: str, rng: np.random.Generator) -> None:
    """[7] 1: under ``root``, a SceneFlow tree (``SF_PAIRS`` pairs at
    ``FRAME``, FlyingThings3D's ``frames_finalpass`` / ``disparity``
    layout, PFM GT); KITTI-2015 ``training/`` (``KITTI_PAIRS`` pairs at
    ``KITTI_FRAME``, uint16 GT with zeros as invalid pixels: none above
    the horizon, half of the rest) and ``testing/`` trees; a Middlebury and
    an ETH3D scene directory (``im0``/``im1``, PFM GT with inf as invalid,
    ``mask0nocc.png`` with an occluded band)."""
    for i, (left, right, disp) in enumerate(scene_pairs(rng, SF_PAIRS,
                                                        FRAME)):
        rel = os.path.join("TRAIN", "A", f"{i:04d}")
        base = os.path.join(root, "sceneflow")
        write_file(os.path.join(base, "frames_finalpass", rel, "left",
                                "0006.png"), left)
        write_file(os.path.join(base, "frames_finalpass", rel, "right",
                                "0006.png"), right)
        write_file(os.path.join(base, "disparity", rel, "left", "0006.pfm"),
                   disp)
    for split in ("training", "testing"):
        base = os.path.join(root, "kitti15", split)
        for i, (left, right, disp) in enumerate(scene_pairs(
                rng, KITTI_PAIRS, KITTI_FRAME)):
            name = f"{i:06d}_10.png"
            write_file(os.path.join(base, "image_2", name), left)
            write_file(os.path.join(base, "image_3", name), right)
            if split == "training":
                gt = np.round(disp * 256).astype(np.uint16)
                gt[:KITTI_FRAME[0] // 3] = 0
                gt[rng.random(gt.shape) < 0.5] = 0
                write_file(os.path.join(base, "disp_occ_0", name), gt)
    for scene, frame in (("middlebury/Adirondack", MID_FRAME),
                         ("eth3d/delivery_area_1l", ETH3D_FRAME)):
        base = os.path.join(root, scene)
        (left, right, disp), = scene_pairs(rng, 1, frame)
        disp = disp.copy()
        disp[:, :8] = np.inf
        mask = np.full(frame, 255, np.uint8)
        mask[:, -24:] = 128
        for name, data in (("im0.png", left), ("im1.png", right),
                           ("disp0GT.pfm", disp), ("mask0nocc.png", mask)):
            write_file(os.path.join(base, name), data)


@contextlib.contextmanager
def recorded_frames():
    """While open, every ``InferenceRunner`` call's disparity, in order:
    what the evaluation CLIs computed, read where they read it."""
    frames: list = []
    call = InferenceRunner.__call__

    def record(self, left, right):
        out = call(self, left, right)
        frames.append(out[0])
        return out

    InferenceRunner.__call__ = record
    try:
        yield frames
    finally:
        InferenceRunner.__call__ = call


def run_cli(name: str, module, argv: list, smi: str,
            epe: bool = True) -> str:
    """``module.main(argv)`` in this process, from launch counters at 0:
    exit 0 and, with ``epe``, EPE figures printed, every one finite; its
    output (its last lines echoed, also when it raises) and wall time
    printed."""
    buf = io.StringIO()
    reset_launches()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            rc = module.main(argv)
        torch.cuda.synchronize()
    finally:
        out = buf.getvalue()
        for line in out.splitlines()[-6:]:
            print(f"    {line[:200]}")
    seconds = time.perf_counter() - start
    require(rc == 0, f"{name} returned {rc}")
    epes = [float(v) for v in EPE_RE.findall(out)]
    require(bool(epes) == epe and all(math.isfinite(v) for v in epes),
            f"{name} printed the EPE figures {epes}")
    print(f"  {name}: exit 0 in {seconds:.2f} s wall, "
          f"{len(epes)} EPE figures, all finite ({smi})")
    return out


def require_launches(name: str, per_kernel: int, form: str) -> None:
    """Kernels A, B and C each launched ``per_kernel`` times in ``form``
    since the counters were set to 0, and no other kernel."""
    kernels = wrappers()
    got = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    want = dict.fromkeys(EVAL_KERNELS, per_kernel)
    require(got == want, f"{name} launched {got} (want {want})")
    for k in EVAL_KERNELS:
        forms = dict(kernels[k].form_launches)
        require(forms == {form: per_kernel},
                f"{name}: {k} launched the forms {forms} (want {form})")


def check_entry_points(smi: str) -> None:
    """[7] the seven CLIs' ``main``, in process, on the card, on the trees
    of ``write_trees``: every exit 0, every printed EPE finite, the
    checkpoints written; the evaluation CLIs launch A, B and C once a
    frame (in bf16 under --dtype bfloat16), the training CLIs none in
    their steps (A, B and C once a batch of their end-of-epoch test);
    save_disp's PNGs, read back through the port's decoder, equal to
    round(clip(disparity, 0, 255) * 256) of the runner's output exactly;
    test_kitti at M on the card within 1e-4 of max|CPU| of the same CLI
    with --cpu on every pixel (TF32 off: the runner's own flags)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        start = time.perf_counter()
        write_trees(root, np.random.default_rng(SEED + 10))
        print(f"  trees written in {time.perf_counter() - start:.2f} s")
        sf, k15 = os.path.join(root, "sceneflow"), \
            os.path.join(root, "kitti15")
        lists = {}
        for kind, src, n in (("sceneflow_train", sf, SF_PAIRS),
                             ("kitti15", k15, KITTI_PAIRS)):
            lists[kind] = os.path.join(root, f"{kind}.txt")
            run_cli(f"make_filelists {kind}", make_filelists,
                    [kind, src, "-o", lists[kind]], smi, epe=False)
            require(len(read_all_lines(lists[kind])) == n,
                    f"make_filelists {kind}: not {n} entries")

        logs = os.path.join(root, "logs_sceneflow")
        run_cli("train_sceneflow", train_sceneflow, [
            "--datapath", sf, "--trainlist", lists["sceneflow_train"],
            "--testlist", lists["sceneflow_train"], "--epochs", "1",
            "--crop", "%d,%d" % TRAIN_CROP, "--eval_crop", "%d,%d" % EVAL_CROP,
            "--logdir", logs], smi)
        ckpt = checkpoints.checkpoint_path(logs, 0)
        require(os.path.exists(ckpt), f"train_sceneflow wrote no {ckpt}")
        require_launches("train_sceneflow (its one test batch)", 1, "fp32")

        kitti = ["--datapath", os.path.join(k15, "training"), "--loadckpt",
                 ckpt]
        for label, flags, form in (("fp32", [], "fp32"),
                                   ("bf16, tanh GELU",
                                    ["--dtype", "bfloat16"], "bf16")):
            viz = os.path.join(root, f"viz_{form}")
            with recorded_frames() as frames, (
                    tanh_gelu() if form == "bf16"
                    else contextlib.nullcontext()):
                out = run_cli(f"test_kitti ({label})", test_kitti,
                              [*kitti, *flags, "--save_dir", viz], smi)
            require(len(frames) == KITTI_PAIRS,
                    f"test_kitti served {len(frames)} frames")
            require_launches(f"test_kitti ({label})", KITTI_PAIRS, form)
            for sub in ("error", "gt", "disp"):
                names = sorted(os.listdir(os.path.join(viz, sub)))
                require(len(names) == KITTI_PAIRS and all(
                    png.read_rgb(os.path.join(viz, sub, n)).shape
                    == (*KITTI_FRAME, 3) for n in names),
                    f"test_kitti ({label}): {sub} PNGs {names}")
            fwd = re.search(r"#### mean forward ([0-9.]+) ms", out)
            require(fwd, f"test_kitti ({label}) printed no mean forward")
            print(f"  test_kitti ({label}, L, {KITTI_FRAME[0]}x"
                  f"{KITTI_FRAME[1]} padded to {KITTI_PADDED[0]}x"
                  f"{KITTI_PADDED[1]}): mean forward {fwd.group(1)} ms a "
                  f"frame (host clock, copies included) on {smi}")

        preds = os.path.join(root, "predictions")
        with recorded_frames() as frames:
            run_cli("save_disp", save_disp, [
                "--datapath", os.path.join(k15, "testing"), "--loadckpt",
                ckpt, "--outdir", preds], smi, epe=False)
        require_launches("save_disp", KITTI_PAIRS, "fp32")
        names = sorted(os.listdir(preds))
        require(len(names) == len(frames) == KITTI_PAIRS,
                f"save_disp wrote {names} for {len(frames)} frames")
        for name, pred in zip(names, frames):
            got = png.read_png(os.path.join(preds, name))
            want = np.round(np.clip(pred, 0, 255) * 256).astype(np.uint16)
            require(got.dtype == np.uint16 and np.array_equal(got, want),
                    f"save_disp {name}: the PNG differs from the runner's "
                    f"output")
        print(f"  save_disp: {len(names)} uint16 PNGs equal "
              f"round(clip(disparity, 0, 255) * 256) of the runner's output "
              f"bit for bit")

        for name, module, scene in (("test_mid", test_mid, "middlebury"),
                                    ("test_eth3d", test_eth3d, "eth3d")):
            run_cli(f"{name} (S)", module, [
                *S_FLAGS, "--datapath", os.path.join(root, scene)], smi)
            require_launches(name, 1, "fp32")

        kitti_logs = os.path.join(root, "logs_kitti")
        run_cli("train_kitti", train_kitti, [
            "--datapath_12", k15, "--datapath_15", k15,
            "--trainlist", lists["kitti15"], "--testlist", lists["kitti15"],
            "--epochs", "1", "--max_batches", "1", "--batch_size", "2",
            "--crop", "%d,%d" % TRAIN_CROP, "--pad_to", "%d,%d" % KITTI_PADDED,
            "--save_freq", "1", "--loadckpt", ckpt, "--logdir", kitti_logs],
            smi)
        require(os.path.exists(checkpoints.checkpoint_path(kitti_logs, 0)),
                "train_kitti wrote no checkpoint")
        require_launches("train_kitti (its one test batch)", 1, "fp32")

        runs = {}
        for where, flags in (("card", []), ("CPU", ["--cpu"])):
            with recorded_frames() as frames:
                run_cli(f"test_kitti (M, {where})", test_kitti, [
                    "--cv_scale", "8", "--limit", "1", "--datapath",
                    os.path.join(k15, "training"), *flags], smi)
            runs[where] = frames
        got, want = runs["card"][0], runs["CPU"][0]
        peak = float(np.abs(want).max())
        rel = float(np.abs(got - want).max()) / peak
        print(f"  test_kitti at M: card against --cpu, max err {rel:.3e} of "
              f"max|CPU| {peak:.3e} on {got.size} pixels (tolerance 1e-4 "
              f"on every pixel)")
        require(got.shape == want.shape == KITTI_FRAME and peak > 0.0
                and rel < 1e-4, "test_kitti at M: the card disagrees with "
                "the CPU")
        print(f"  [7] {time.perf_counter() - start:.1f} s in all on {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# [8]: export and native serving: cli/export.py's package of each path at
# the CLI's default size, served by the C++ runner (serving/) on a seeded
# KITTI-sized pair that it pads, from seeded weights saved with
# train/checkpoints.py
SERVE_SIZE = (384, 1248)          # cli/export.py's --height, --width
SERVE_FRAMES = 20
SERVE_WARMUP = 3
SERVE_PATHS = {"L-deploy": (DEPLOY_PATHS["L-deploy"], False),
               "C": (S_NORM, True)}
# the esmstereo:: operators a frame launches on each path, as [5] counts
# their wrappers (A, B, and C's two convs on L-deploy; A and B on C)
SERVE_LAUNCHES = {
    "L-deploy": {"fused_stage0": 1, "correlation_volume": 1,
                 "conv3d_bn_gelu": 0, "conv3d_bn_gelu_bf16": 2},
    "C": {"fused_stage0": 1, "correlation_volume": 1, "conv3d_bn_gelu": 0,
          "conv3d_bn_gelu_bf16": 0}}


def serve_weights_(name: str, model, gen: torch.Generator) -> None:
    """[8]'s seeded weights of ``model``: those [4] holds each path at, the
    init rule's, and for C ``scale_bn3`` (zero at init) drawn in [0.75,
    1.25) from ``gen``, as ``check_against_cpu`` draws it. Not
    fan-in-scaled ones (``fan_in_scaled_``): under them L's refinement
    carries the disparity to +-3e4 px and bf16 against fp32 moves 99.9% of
    its pixels by more than 1 px (mean 1207 px), and C's confidence map
    saturates while fp32 rounding is amplified to 1.4e-4 between the
    package and eager (on the H100): [4] holds such weights against
    float64 (``check_conditioning``), not at these bounds."""
    if name == "C":
        bn = model.confidence_net.scale_bn3
        with torch.no_grad():
            bn.weight.copy_(0.75 + 0.5 * torch.rand(bn.weight.shape,
                                                    generator=gen))


def serve_args(config: ESMStereoConfig, confidence: bool, loadckpt: str):
    """``eval/serve_e2e.py``'s arguments for ``config``."""
    argv = ["--backbone", config.backbone, "--cv_scale",
            str(config.cv_scale), "--cv", config.cost_volume, "--dtype",
            config.dtype, "--maxdisp", str(config.max_disp), "--loadckpt",
            loadckpt, "--height", str(SERVE_SIZE[0]), "--width",
            str(SERVE_SIZE[1]), "--frames", str(SERVE_FRAMES), "--warmup",
            str(SERVE_WARMUP)]
    return serve_e2e.build_parser().parse_args(
        argv + (["--confidence"] if confidence else []))


def check_served_deploy(name: str, got: np.ndarray, eager: np.ndarray,
                        fp32: np.ndarray) -> None:
    """[4]'s cv4 deploy bounds, pooled over the pixels of its
    ``DEPLOY_DRAWS`` pairs (``served_deploy_runs``): the package's
    disparity against the eager deploy path within ``CV4_MARGIN`` times
    the deploy numerics' own distance (the eager deploy path against the
    eager fp32 path with exact GELU) in mean, in the share of pixels off
    by more than 1 px and in the others' mean (or 0.05 px). [4] holds that
    last one at 1 times; here it gets the margin of the other two: at
    384x1248 the package, the eager deploy path and the fp32 path are
    three runs that sit as far from one another (on the H100, means 2.99,
    3.36 and 3.32 px, 37-39% of pixels off by more than 1 px, the others'
    means 0.0906, 0.0836 and 0.0833 px), so that at 1 times the verdict is
    a draw's."""
    g, c, r = (torch.from_numpy(m) for m in (got, eager, fp32))
    card, own = (g - c).abs(), (c - r).abs()
    ratio = float(card.mean()) / float(own.mean())

    def flips(a, b):
        diff = (a - b).abs()
        off = diff > 1.0
        return float(off.float().mean()), float(diff[~off].mean())

    (fl, sub), (own_fl, own_sub) = flips(g, c), flips(c, r)
    print(f"  {name}: package against eager, disparity mean "
          f"{float(card.mean()):.4e}, {ratio:.4f} times the deploy "
          f"numerics' own {float(own.mean()):.4e} (at most {CV4_MARGIN}); "
          f"{fl:.3%} of pixels off by more than 1 px, {sub:.4f} px mean over "
          f"the others (bounds {max(0.05, CV4_MARGIN * own_fl):.3%}, "
          f"{max(0.05, CV4_MARGIN * own_sub):.4f} px; own {own_fl:.3%}, "
          f"{own_sub:.4f} px)")
    require(card.mean() <= CV4_MARGIN * own.mean()
            and fl < max(0.05, CV4_MARGIN * own_fl)
            and sub < max(0.05, CV4_MARGIN * own_sub),
            f"{name}: the package is outside [4]'s deploy bounds")


def served_deploy_runs(result: dict, args, config: ESMStereoConfig,
                       weights: str) -> tuple:
    """The disparities [4]'s deploy check pools, over ``DEPLOY_DRAWS``
    pairs (the served pair and seeded 375x1242 pairs after it, padded as
    the runner pads them): the package's in Python, the eager deploy
    path's (tanh GELU) and the eager fp32 path's with exact GELU (the
    deploy numerics' own distance), each concatenated."""
    program = torch._inductor.aoti_load_package(result["package"])
    deploy_net = serve_e2e.eager_model(args)
    fp32 = serve_e2e.eager_model(serve_args(
        dataclasses.replace(config, dtype="float32"), False, weights))
    runs = ([result["package_maps"][0]], [result["eager_maps"][0]], [])
    pairs = [result["inputs"]] + [
        [serve_e2e.preprocess(im, *SERVE_SIZE) for im in
         serve_e2e.seeded_pair(SEED + 300 + k, KITTI_FRAME)]
        for k in range(DEPLOY_DRAWS - 1)]
    for k, inputs in enumerate(pairs):
        dev = [torch.from_numpy(x).cuda() for x in inputs]
        with serve_e2e.serving_numerics():
            runs[2].append(serve_e2e.maps(fp32(*dev))[0])
            if k:
                runs[0].append(serve_e2e.maps(program(*dev))[0])
                with tanh_gelu():
                    runs[1].append(serve_e2e.maps(deploy_net(*dev))[0])
    return tuple(np.concatenate(r) for r in runs)


def check_serving(smi: str, request_ms: dict) -> None:
    """[8] for each of ``SERVE_PATHS``: seeded weights (``serve_weights_``)
    saved with ``checkpoints.save_weights``; ``eval/serve_e2e.py`` exports
    them through ``cli/export.py`` (L-deploy under tanh GELU), serves a
    seeded 375x1242 pair with the runner built in [2], and runs the same
    package in Python and the eager kernel path on the same inputs. The
    runner's uint16 disparity (and C's confidence map) must equal the
    package's in Python through the same pre- and post-processing bit for
    bit; the package's raw maps must hold against eager within [4]'s
    bounds (L-deploy: ``check_served_deploy``; C: every pixel within 1e-4
    of max|eager|); the runner's and the Python run's launch counters must
    read ``SERVE_LAUNCHES`` a frame. Prints the export and
    compile seconds, the package's size, the runner's ms a frame (host
    clock and CUDA events) beside [5]'s eager request ms and the eager
    request ms on this pair."""
    start = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 200)
    for name, (config, confidence) in SERVE_PATHS.items():
        cls = ESMStereoConfidence if confidence else ESMStereo
        with tempfile.TemporaryDirectory() as root:
            model = cls(config, device="cpu", seed=SEED)
            serve_weights_(name, model, gen)
            weights = checkpoints.save_weights(os.path.join(root, "w.pt"),
                                               model)
            args = serve_args(config, confidence, weights)
            deploy_path = config.dtype == "bfloat16"
            with tanh_gelu() if deploy_path else contextlib.nullcontext():
                result = serve_e2e.serve(args, root, KITTI_FRAME)
                eager_times = serve(serve_e2e.eager_model(args),
                                    np.random.default_rng(SEED),
                                    KITTI_FRAME)
            if deploy_path:
                pooled = served_deploy_runs(result, args, config, weights)
        verdict = serve_e2e.summary(result)
        runner = verdict["runner"]
        print(f"  {name}: exported in {result['export_s']:.2f} s, "
              f"AOTInductor compiled in {result['compile_s']:.2f} s, package "
              f"{result['package_bytes'] / 1e6:.2f} MB, runner built in "
              f"{result['runner_build_s']:.2f} s ({smi})")
        print(f"  {name}: runner {runner['host_ms_median']:.3f} ms a frame "
              f"(host clock, median of {runner['frames']}; mean "
              f"{runner['host_ms_mean']:.3f}), device "
              f"{runner['device_ms_median']:.3f} ms (CUDA events, median; "
              f"mean {runner['device_ms_mean']:.3f}); eager request ms on "
              f"this pair {[round(t, 2) for t in eager_times]}, in [5] "
              f"{[round(t, 2) for t in request_ms[name]]} ({smi})")
        print(f"  {name}: {result['runner']['stderr'].strip()}")
        print(f"  {name}: runner EPE {runner['epe']:.4f} px against the "
              f"pair's {serve_e2e.SHIFT} px shift on "
              f"{runner['valid_pixels']} pixels (random weights)")
        require(math.isfinite(runner["epe"]), f"{name}: EPE not finite")
        require(verdict["runner_bit_for_bit"],
                f"{name}: the runner's uint16 maps differ from the package "
                f"run in Python")
        print(f"  {name}: the runner's uint16 disparity"
              f"{' and confidence map' if confidence else ''} equal the "
              f"package's in Python bit for bit "
              f"({int((result['golden_u16'] > 0).sum())} valid pixels)")
        want = SERVE_LAUNCHES[name]
        require(verdict["launches_per_frame"] == want
                and result["python_launches"] == want,
                f"{name}: launches a frame {verdict['launches_per_frame']} "
                f"(runner), {result['python_launches']} (Python), want "
                f"{want}")
        print(f"  {name}: launches a frame {verdict['launches_per_frame']} "
              f"in the runner over {runner['runs']} runs, as in Python")
        pkg, eager = result["package_maps"], result["eager_maps"]
        require(all(p.shape == SERVE_SIZE and np.isfinite(p).all()
                    for p in pkg), f"{name}: package maps")
        if deploy_path:
            check_served_deploy(name, *pooled)
        else:
            for key, g, w in zip(("disparity", "confidence"), pkg, eager):
                peak = float(np.abs(w).max())
                rel = float(np.abs(g - w).max()) / peak
                print(f"  {name} {key}: package against eager max err "
                      f"{rel:.3e} of max|eager| {peak:.3e} (tolerance 1e-4 "
                      f"on every pixel)")
                require(peak > 0.0 and rel < 1e-4,
                        f"{name} {key}: the package disagrees with eager")
    print(f"  [8] {time.perf_counter() - start:.1f} s in all on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    started = time.perf_counter()
    smi = smi_line()
    print(f"[1] card: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    runner_build = serving_build.start()
    libs = _build.build_all()
    runner_bin = serving_build.finish(runner_build)
    print(f"[2] built {len(_build.SOURCES)} kernel libraries, the ops and "
          f"definitions libraries and the native runner in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        print(f"  {name}:\n    " + _build.ptxas_report(name).replace(
            "\n", "\n    "))
    for name in (_build.OPS, _build.DEFS):
        print(f"  {name}: {libs[name].name}")
    print(f"  runner: {runner_bin.name}")

    gen = torch.Generator().manual_seed(SEED)
    model = ESMStereo(device="cuda", seed=SEED)
    m_gwc = ESMStereo(M, device="cuda", seed=SEED)
    m_norm = ESMStereo(M_NORM, device="cuda", seed=SEED)
    s_gwc = ESMStereo(S, device="cuda", seed=SEED)
    s_norm = ESMStereo(S_NORM, device="cuda", seed=SEED)
    conf = ESMStereoConfidence(S_NORM, device="cuda", seed=SEED)
    print("[3] kernels against their plain versions, main-path shapes")
    with torch.inference_mode():
        rows = [check_fused_stage0(model, gen, "default"),
                check_stems(model, gen, "all")]
        # L: kernel C on kernel B's volume, then E, G, H, I
        row_b, volume = check_correlation_volume(model, gen, "gwc",
                                                 "default")
        row_c = check_stem_agg(model, volume, "default")
        del volume
        rows += [row_b, row_c, check_volume_stem_agg(model, gen, "fused")]
        row_g, downs = check_down_pairs(model, gen, "fused")
        rows += [row_g, check_up_pairs(model, gen, downs, "fused"),
                 check_mixer(model, gen)]
        # M: the three forms of the volume (gwc_norm is on no model's path),
        # C on the gwc volume and on a 1-channel one, E normalised, G, H
        row_b, volume = check_correlation_volume(m_gwc, gen, "gwc", "M")
        rows += [row_b, check_stem_agg(m_gwc, volume, "M")]
        del volume
        rows += [check_correlation_volume(m_norm, gen, form, path)[0]
                 for form, path in (("norm", "M-norm"), ("gwc_norm", None))]
        vol1 = torch.randn((1, 1, m_norm.num_bins, *desc_shape(m_norm)[2:]),
                           generator=gen).cuda()
        rows += [check_stem_agg(m_norm, vol1, "M-norm"),
                 check_volume_stem_agg(m_norm, gen, "M-norm-all")]
        del vol1
        row_g, downs = check_down_pairs(m_norm, gen, "M-norm-all")
        rows += [row_g, check_up_pairs(m_norm, gen, downs, "M-norm-all")]
        # S: A's mobilenetv2 form, F at (16, 24), B (gwc and norm) and C at
        # 12 bins, G and H at 8 -> 12 -> 16 -> 24 channels
        rows += [check_fused_stage0(s_gwc, gen, "S"),
                 check_stems(s_gwc, gen, "S-all")]
        row_b, volume = check_correlation_volume(s_gwc, gen, "gwc", "S")
        rows += [row_b, check_stem_agg(s_gwc, volume, "S"),
                 check_correlation_volume(s_norm, gen, "norm", "S-norm")[0]]
        del volume
        row_g, downs = check_down_pairs(s_gwc, gen, "S-all")
        rows += [row_g, check_up_pairs(s_gwc, gen, downs, "S-all")]
        # C: A's mobilenetv2 form and B's normalised form at the KITTI
        # frame's 384 x 1248 (descriptors (1, 64, 24, 78), 12 bins)
        c_rows = [check_fused_stage0(conf.stereo, gen, "C", KITTI_PADDED),
                  check_correlation_volume(conf.stereo, gen, "norm", "C",
                                           KITTI_PADDED)[0]]
        rows += [dict(r, model="C") for r in c_rows]
        # the deploy forms (bf16, tanh GELU): A writing bf16 in both forms;
        # B's gwc and normalised bf16 forms; D's three bf16 forms and B's
        # gwc_norm (no path builds them); C's bf16 form on B's gwc volume
        # (L, M, S) or on a unit-normal 1-channel volume (M-norm: the
        # normalised one is at most 1/64) and its int8 form on that
        # volume quantised
        rows.append(check_fused_stage0_bf16(model, gen, "L-deploy"))
        row_b, volume = check_correlation_bf16(model, gen, "gwc", "L-deploy")
        with tanh_gelu():
            rows += [row_b,
                     check_stem_agg_deploy(model, volume, "bf16", "L-deploy"),
                     check_stem_agg_deploy(model, volume, "int8",
                                           "L-deploy-int8")]
        del volume
        rows += [check_fused_stage0_bf16(s_gwc, gen, "S-deploy"),
                 check_fused_stage0_bf16(conf.stereo, gen, "C-deploy",
                                         KITTI_PADDED)]
        rows += [check_correlation_bf16(net, gen, "norm", path, padded)[0]
                 for net, path, padded in (
                     (m_norm, "M-norm-deploy", PADDED),
                     (s_norm, "S-norm-deploy", PADDED),
                     (conf.stereo, "C-deploy", KITTI_PADDED))]
        rows += [check_correlation_bf16(m_gwc, gen, form, None,
                                        round_products=rounding)[0]
                 for form in FORMS for rounding in (True, False)
                 if form == "gwc_norm" or not rounding]
        with tanh_gelu():
            for net, path in ((m_gwc, "M-deploy"), (s_gwc, "S-deploy")):
                row_b, volume = check_correlation_bf16(net, gen, "gwc", path)
                rows += [row_b,
                         check_stem_agg_deploy(net, volume, "bf16", path),
                         check_stem_agg_deploy(net, volume, "int8", None,
                                               f"{path}-int8")]
                del volume
            vol1 = torch.randn((1, 1, m_norm.num_bins,
                                *desc_shape(m_norm)[2:]),
                               generator=gen).cuda()
            rows += [check_stem_agg_deploy(m_norm, vol1, "bf16",
                                           "M-norm-deploy"),
                     check_stem_agg_deploy(m_norm, vol1, "int8", None,
                                           "M-norm-deploy-int8")]
            del vol1
            # the switches' deploy forms (bf16): F, E, G, H and I on the
            # L-deploy-all path, E's normalised form and G, H at M's widths
            # on M-norm-deploy-all, F at (16, 24) and G, H with the masked
            # 12-channel tile on S-deploy-all
            rows += [check_stems_deploy(model, gen, "L-deploy-all"),
                     check_volume_stem_agg_bf16(model, gen, "L-deploy-all")]
            row_g, downs = check_down_pairs_bf16(model, gen, "L-deploy-all")
            rows += [row_g,
                     check_up_pairs_bf16(model, gen, downs, "L-deploy-all"),
                     check_mixer_bf16(model, gen, "L-deploy-all"),
                     check_volume_stem_agg_bf16(m_norm, gen,
                                                "M-norm-deploy-all")]
            row_g, downs = check_down_pairs_bf16(m_norm, gen,
                                                 "M-norm-deploy-all")
            rows += [row_g, check_up_pairs_bf16(m_norm, gen, downs,
                                                "M-norm-deploy-all"),
                     check_stems_deploy(s_gwc, gen, "S-deploy-all")]
            row_g, downs = check_down_pairs_bf16(s_gwc, gen, "S-deploy-all")
            rows += [row_g, check_up_pairs_bf16(s_gwc, gen, downs,
                                                "S-deploy-all")]
        # the bf16 activations per op, at the largest tensor each runs on
        # in the per-op paths
        per_op = {path: (ESMStereoConfidence if path.startswith("C-")
                         else ESMStereo)(config, device="cuda", seed=SEED)
                  for path, config in PER_OP_PATHS.items()}
        rows += [check_activation(name, path, shape, gen)
                 for name, (path, shape) in sorted(activation_shapes(
                     per_op).items())]
        del per_op
        # kernel J over stages 1-5 of L's and S's backbones (on no path)
        rows += [check_fused_stages(net, gen, None) for net in (model, s_gwc)]
        # the conv3d k3 p1 that C, E's agg, G and H share, conv by conv
        print("  the shared conv3d k3 p1 at each of its shapes:")
        rows += check_convs([
            ("L", model, "default", "fused", "L-deploy", "L-deploy-all"),
            ("M", m_gwc, "M", "M-norm-all", "M-deploy", "M-norm-deploy-all"),
            ("M-norm", m_norm, "M-norm", "M-norm-all", "M-norm-deploy",
             "M-norm-deploy-all"),
            ("S", s_gwc, "S", "S-all", "S-deploy", "S-deploy-all")], gen)
        for r in rows:
            lib = r["library_ms"]
            lib = "none" if lib is None else f"{lib:.4f} ms"
            form = f" {r['form']}" if "form" in r else ""
            print(f"  {r['name']}{form} ({r['model']}): {r['ms']:.4f} ms "
                  f"(plain {r['plain_ms']:.4f} ms, library {lib}, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
            for lv in r.get("levels", []):
                print(f"    level {lv['level']}: {lv['ms']:.4f} ms (plain "
                      f"{lv['plain_ms']:.4f} ms, library "
                      f"{lv['library_ms']:.4f} ms, bound "
                      f"{lv['bound_ms']:.4f} ms by {lv['bound_by']})")
            if "cluster" in r:
                print(f"    {r['conv']} {r['input']} s{r['stride']}: tile "
                      f"{r['tile']}, cluster {r['cluster']}, {r['blocks']} "
                      f"blocks")
            if "b_plus_c_ms" in r:
                print(f"    beside kernels B + C on the same inputs: "
                      f"{r['ms']:.4f} ms against {r['b_plus_c_ms']:.4f} ms")
        print("  ragged shapes:")
        check_ragged(model, m_norm, s_gwc, gen)
        check_ragged_deploy(model, m_norm, s_gwc, gen)
        check_ragged_switches_deploy(model, m_norm, s_gwc, gen)
        check_ragged_stages(model, s_gwc, gen)

    # the served paths' configurations (C's is S-norm's), each switch alone
    # at cv4, and L with the norm-correlation volume
    paths = {"default": ESMStereoConfig(), "fused": FUSED, "all": ALL,
             "M": M, "M-norm": M_NORM, "M-norm-all": M_NORM_ALL,
             "S": S, "S-norm": S_NORM, "S-all": S_ALL}
    for name, config in (*paths.items(),
                         *((f"{k} alone", ESMStereoConfig(**{k: True}))
                           for k in SWITCHES),
                         ("L-norm", L_NORM), ("L-norm-all", L_NORM_ALL)):
        print(f"[4] {name} model on the card against the CPU, 128x256")
        check_against_cpu(gen, config)
    print("[4] C (the confidence model on S-norm) on the card against the "
          "CPU, 128x256")
    check_against_cpu(gen, S_NORM, confidence=True)
    # the card at fan-in-scaled weights, against float64: the paths whose
    # kernels feed match_left with kernel F (L with fuse_stems alone,
    # M-norm-all, S-all)
    for name, config in (("fuse_stems alone", ESMStereoConfig(fuse_stems=True)),
                         ("M-norm-all", M_NORM_ALL), ("S-all", S_ALL)):
        print(f"[4] {name} at fan-in-scaled weights: the card and the CPU "
              f"in fp32 against the CPU in float64, 128x256")
        check_conditioning(name, config)
    for name, config in (*DEPLOY_PATHS.items(), *CPU_HELD_DEPLOY.items()):
        print(f"[4] {name} (bf16, tanh GELU) on the card against the CPU, "
              f"beside the CPU's own distance from fp32, 128x256")
        check_deploy_against_cpu(gen, config,
                                 confidence=name.startswith("C-"),
                                 ulp_slack=name not in STRICT_DEPLOY)
    for name, config in (*SWITCHED_PATHS.items(), *CPU_HELD_SWITCHED.items()):
        print(f"[4] {name} (bf16, tanh GELU) on the card against the CPU, "
              f"beside the CPU's own distance from fp32, 128x256")
        check_deploy_against_cpu(gen, config)
    for name, config in PER_OP_PATHS.items():
        print(f"[4] {name} (bf16, tanh GELU, the activations per op on both) "
              f"on the card against the CPU, beside the CPU's own distance "
              f"from fp32, 128x256")
        with bf16_per_op():
            check_deploy_against_cpu(gen, config,
                                     confidence=name.startswith("C-"))

    # last among the checks that draw from gen, so that no earlier draw
    # moves (A's and I's ragged tiles and their graph capture after F's and
    # H's)
    print("[3] ragged tiles of F's deploy kernel and H's fused transposed "
          "+ 1x1x1 conv")
    with torch.inference_mode():
        check_ragged_stem_up_tiles(model, m_norm, s_gwc, gen)
    print("[3] ragged tiles of kernels A and I")
    with torch.inference_mode():
        check_ragged_head_mixer(model, s_gwc, gen)
    print("[3] kernels A and I captured into a CUDA graph")
    with torch.inference_mode():
        check_graph_capture(model, gen)
    print("[3] ragged tiles of kernel B and of F's fp32 form")
    with torch.inference_mode():
        check_ragged_volume_stem_tiles(model, s_gwc, gen)
    print("[3] kernel B's served forms and F's fp32 form captured into a "
          "CUDA graph")
    with torch.inference_mode():
        check_graph_capture_volume_stems(model, m_norm, s_gwc, gen)

    nets = {"default": model, "M": m_gwc, "M-norm": m_norm, "S": s_gwc,
            "S-norm": s_norm}
    for name, source in (("fused", model), ("all", model),
                         ("M-norm-all", m_norm), ("S-all", s_gwc)):
        nets[name] = ESMStereo(paths[name], device="cuda", seed=SEED)
        nets[name].load_state_dict(source.state_dict())
    nets["C"] = conf
    # the deploy paths on the fp32 paths' weights
    sources = {"L-deploy": model, "L-deploy-int8": model, "M-deploy": m_gwc,
               "M-norm-deploy": m_norm, "S-deploy": s_gwc,
               "S-norm-deploy": s_norm, "C-deploy": conf,
               "L-deploy-all": model, "M-norm-deploy-all": m_norm,
               "S-deploy-all": s_gwc}
    sources.update({"M-deploy per-op": m_gwc, "C-deploy per-op": conf})
    served_deploy = {**DEPLOY_PATHS, **SWITCHED_PATHS, **PER_OP_PATHS}
    for name, config in served_deploy.items():
        cls = ESMStereoConfidence if name.startswith("C-") else ESMStereo
        nets[name] = cls(config, device="cuda", seed=SEED)
        nets[name].load_state_dict(sources[name].state_dict())
    kernels = wrappers()
    convs = conv_wrappers()
    steps = step_wrappers()
    launches, forms, act_forms, step_launches, request_ms = {}, {}, {}, {}, {}
    conv_launches, conv_forms, conv_shapes = {}, {}, {}
    for name, net in nets.items():
        frame = KITTI_FRAME if name.split("-")[0] == "C" else FRAME
        padded = [(n // 32 + 1) * 32 for n in frame]
        with tanh_gelu() if name in served_deploy else \
                contextlib.nullcontext(), bf16_per_op(name in PER_OP_PATHS):
            print(f"[5] {name} path: {REQUESTS} requests through "
                  f"InferenceRunner, {frame[0]}x{frame[1]} padded to "
                  f"{padded[0]}x{padded[1]}, {precision(net)}")
            reset_launches()
            request_ms[name] = serve(net, np.random.default_rng(SEED), frame)
            torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in kernels.items()}
        forms[name] = {k: dict(fn.form_launches) for k, fn in kernels.items()}
        conv_launches[name] = {k: fn.launches for k, fn in convs.items()}
        step_launches[name] = {k: dict(fn.form_launches)
                               for k, fn in steps.items()}
        conv_forms[name], conv_shapes[name] = {}, {}
        for fn in convs.values():
            for mine, theirs in ((conv_forms[name], fn.form_launches),
                                 (conv_shapes[name], fn.shape_launches)):
                for k, n in theirs.items():
                    mine[k] = mine.get(k, 0) + n
        print(f"  launches per request on the {name} path: "
              f"{ {k: n / REQUESTS for k, n in launches[name].items()} }; "
              f"by form: { {k: v for k, v in forms[name].items() if v} }")
    # wrapper calls per request: G runs at 3 levels, H at 2; every other
    # kernel of the port must stay at 0 on that path (I on every cv8 and
    # cv16 path, E on every cv16 path, C where corr_stem and agg are plain)
    default_want = {"fused_stage0": 1, "correlation_volume": 1, "stem_agg": 1}
    fused_want = {"fused_stage0": 1, "volume_stem_agg": 1, "down_pair": 3,
                  "up_pair": 2}
    s_norm_want = {"fused_stage0": 1, "correlation_volume": 1}
    all_want = {**fused_want, "stems": 1, "mixer": 1}
    m_norm_all_want = {**fused_want, "stems": 1}
    s_all_want = {**default_want, "stems": 1, "down_pair": 3, "up_pair": 2}
    want = {"default": default_want, "fused": fused_want, "all": all_want,
            "M": default_want, "M-norm": default_want,
            "M-norm-all": m_norm_all_want,
            "S": default_want, "S-norm": s_norm_want, "S-all": s_all_want,
            "C": s_norm_want, "L-deploy": default_want,
            "L-deploy-int8": default_want, "M-deploy": default_want,
            "M-norm-deploy": default_want, "S-deploy": default_want,
            "S-norm-deploy": s_norm_want, "C-deploy": s_norm_want,
            "L-deploy-all": all_want, "M-norm-deploy-all": m_norm_all_want,
            "S-deploy-all": s_all_want, "M-deploy per-op": default_want,
            "C-deploy per-op": s_norm_want}
    # the bf16 activations' kernel: as many launches on each request of a
    # per-op path, at least one of each activation that path reaches, and
    # none on any other path (the served mode rounds once, in torch)
    reached = {"M-deploy per-op": {"gelu_tanh", "silu", "sigmoid"},
               "C-deploy per-op": {"gelu_tanh", "silu", "softmax",
                                   "sigmoid"}}
    for path, names in reached.items():
        n = launches[path].pop("activation_bf16")
        by_name = forms[path].pop("activation_bf16")
        require(n > 0 and n % REQUESTS == 0 and set(by_name) == names
                and sum(by_name.values()) == n,
                f"activation_bf16 launched {by_name} in {REQUESTS} requests "
                f"on the {path} path (want each of {sorted(names)}, as "
                f"often on each request)")
        forms[path]["activation_bf16"] = {}
        launches[path]["activation_bf16"] = 0
        act_forms[path] = by_name
    for path, per_request in want.items():
        for k, n in launches[path].items():
            require(n == per_request.get(k, 0) * REQUESTS,
                    f"{k} launched {n} times in {REQUESTS} requests on the "
                    f"{path} path (want {per_request.get(k, 0)} a request)")
    # the shared conv3d k3 p1: 2 a C, 1 an E, 2 a G level, 1 an H level,
    # every one in fp32 on the fp32 paths and in a deploy form (bf16; C's
    # first on the int8 volume) on the deploy paths
    for path, per_request in want.items():
        n = REQUESTS * (2 * per_request.get("stem_agg", 0)
                        + per_request.get("volume_stem_agg", 0)
                        + 2 * per_request.get("down_pair", 0)
                        + per_request.get("up_pair", 0))
        deploy = path in served_deploy
        int8 = (REQUESTS * per_request.get("stem_agg", 0)
                if path == "L-deploy-int8" else 0)
        want_forms = ({"bf16": n - int8, "int8_bf16": int8} if deploy
                      else {"fp32": n})
        want_forms = {k: v for k, v in want_forms.items() if v}
        require(conv_launches[path] == {"conv3d": 0 if deploy else n,
                                        "conv3d_bf16": n if deploy else 0}
                and conv_forms[path] == want_forms,
                f"the shared conv launched {conv_launches[path]} in the forms "
                f"{conv_forms[path]} in {REQUESTS} requests on the {path} "
                f"path (want {want_forms})")
    # H's deploy form: its fused transposed + 1x1x1 conv once a bf16
    # up_pair call (then the shared conv, counted above), never in fp32;
    # the separate normalisation once a normalised E call, in E's form,
    # and never for B, whose normalised forms are one launch
    for path in want:
        n = forms[path]["up_pair"].get("bf16", 0)
        norm_e = (forms[path]["volume_stem_agg"]
                  if nets[path].config.cost_volume == "norm_correlation"
                  else {})
        steps_want = {"up_cat_bf16": {"bf16": n} if n else {},
                      "l2_normalize_pair": norm_e}
        require(step_launches[path] == steps_want,
                f"the steps launched {step_launches[path]} on the {path} "
                f"path (want {steps_want}: up_cat_bf16 once a bf16 up_pair "
                f"call, l2_normalize_pair once a normalised volume_stem_agg "
                f"call)")
    # the forms each path launched: the deploy forms on the deploy paths
    # only, and nothing but fp32 elsewhere
    gwc_bf16 = {"fused_stage0": "bf16", "correlation_volume": "bf16",
                "stem_agg": "bf16"}
    norm_bf16 = dict(gwc_bf16, correlation_volume="bf16_norm")
    deploy_forms = {"L-deploy": gwc_bf16,
                    "L-deploy-int8": dict(gwc_bf16, stem_agg="int8"),
                    "M-deploy": gwc_bf16, "M-norm-deploy": norm_bf16,
                    "S-deploy": gwc_bf16, "S-norm-deploy": norm_bf16,
                    "C-deploy": norm_bf16, "M-deploy per-op": gwc_bf16,
                    "C-deploy per-op": norm_bf16,
                    **{path: dict.fromkeys(kernels, "bf16") for path in (
                        "L-deploy-all", "M-norm-deploy-all",
                        "S-deploy-all")}}
    for path, by_kernel in forms.items():
        for k, by_form in by_kernel.items():
            n = launches[path][k]
            form = deploy_forms.get(path, {}).get(k, "fp32")
            require(by_form == ({form: n} if n else {}),
                    f"{k} on the {path} path launched the forms {by_form} "
                    f"(want {form} only)")
    for r in rows:
        # a form no path serves (gwc_norm, D's bf16 forms, the int8 forms
        # of M, M-norm and S) has no run that counts its launches; a
        # deploy form's row counts that form's launches on its path; a
        # conv's row the launches of its shape and form on its path
        key = r.pop("form_key", None)
        shape_key = r.pop("shape_key", None)
        if shape_key and r["path"]:
            r["launches"] = conv_shapes[r["path"]].get(shape_key, 0)
            require(r["launches"] > 0, f"conv3d {shape_key} launched no "
                    f"time on the {r['path']} path")
        elif not r["path"]:
            r["launches"] = None
        elif r["name"] == "activation_bf16":
            r["launches"] = act_forms[r["path"]][key]
        elif key:
            r["launches"] = forms[r["path"]][r["name"]][key]
        else:
            r["launches"] = launches[r["path"]][r["name"]]

    print("[6] train: ESMStereo-L, fp32, SceneFlow recipe (AdamW lr 1e-3, "
          f"batch {TRAIN_BATCH} x {TRAIN_CROP[0]}x{TRAIN_CROP[1]} synthetic "
          f"scenes)")
    perf = check_training()
    print(f"  [6] median train step {perf['step_ms']:.2f} ms, peak device "
          f"memory {perf['peak_bytes'] / 2**30:.3f} GiB on {smi}")

    print("[7] the entry points (esmstereo_tpu_torch.cli) on synthetic "
          "SceneFlow, KITTI-2015, Middlebury and ETH3D trees")
    check_entry_points(smi)

    print(f"[8] export and native serving at {SERVE_SIZE[0]}x{SERVE_SIZE[1]} "
          f"(cli/export.py, the C++ runner)")
    check_serving(smi, request_ms)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - started:.1f} s, the build included, on "
          f"{smi}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
