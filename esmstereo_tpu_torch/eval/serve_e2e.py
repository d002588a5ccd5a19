"""End-to-end native serving check: export -> package -> C++ runner ->
golden.

The port's counterpart of ``tools/pjrt_e2e.py:78-159``: export the model
through the export CLI (``cli/export.py``'s ``main``: an AOTInductor
package), build the C++ runner (``serving/build.py``), serve a seeded pair
with it (the right image is the left rolled by 4 columns, as JAX's is),
and hold its uint16 disparity (and confidence map) against the same
package run in Python (``torch._inductor.aoti_load_package``) through the
same pre- and post-processing, written here in numpy: the padding and
ImageNet normalisation of ``serving/src/stereo_pipeline.cc``, its 5x5
median with a replicated border (``median5x5``, no OpenCV), its validity
mask and x256 encoding. Both must agree bit for bit. The package's raw
maps are also held against the eager kernel path on the same inputs, and
the runner's launch counters against the kernels a frame runs.

    python -m esmstereo_tpu_torch.eval.serve_e2e --loadckpt weights.pt \\
        [--height 384 --width 1248] [--cv_scale 16 ...] [--confidence] \\
        [--frames 50] [--out_json serve_e2e.json]

Runs on the card only (the runner is CUDA), and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# stereo_pipeline.cc's ImageNet statistics, in float32 as it has them
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
SHIFT = 4                   # the pair's constant disparity, in pixels
COMPILE_RE = re.compile(r"exported in ([0-9.]+) s, saved in ([0-9.]+) s, "
                        r"AOTInductor compiled in ([0-9.]+) s")


def preprocess(rgb: np.ndarray, height: int, width: int) -> np.ndarray:
    """``PreprocessImage``: uint8 (h, w, 3) -> float32 (1, height, width,
    3), normalised, padded at the top and on the right with zeros."""
    h, w = rgb.shape[:2]
    if h > height or w > width:
        raise ValueError(f"image {h}x{w} larger than {height}x{width}")
    out = np.zeros((height, width, 3), np.float32)
    out[height - h:, :w] = (rgb.astype(np.float32) / np.float32(255.0)
                            - MEAN) / STD
    return out[None]


def median5x5(x: np.ndarray) -> np.ndarray:
    """``MedianFilter5x5``: the median of each 5x5 window, the border
    replicated."""
    p = np.pad(x, 2, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(p, (5, 5))
    win = win.reshape(*x.shape, 25)
    return np.partition(win, 12, axis=-1)[..., 12]


def postprocess(disp: np.ndarray, original: tuple, max_disp: float = 192.0,
                conf: np.ndarray | None = None, threshold: float = 0.5):
    """``PostprocessDisparity`` (``PostprocessDisparityConf`` with
    ``conf``): crop the padding, 5x5 median, zero outside (0, max_disp)
    (and where the confidence is below ``threshold``), x256 as uint16.
    Returns the uint16 map, and with ``conf`` also the cropped
    confidence."""
    oh, ow = original
    top = disp.shape[0] - oh
    med = median5x5(disp[top:, :ow])
    valid = (med > 0) & (med < np.float32(max_disp))
    if conf is not None:
        conf = conf[top:, :ow]
        valid &= conf >= np.float32(threshold)
    u16 = np.minimum(med * np.float32(256.0), np.float32(65535.0)).astype(
        np.uint16)
    u16 = np.where(valid, u16, np.uint16(0))
    return u16 if conf is None else (u16, conf)


def confidence_u16(conf: np.ndarray) -> np.ndarray:
    """The runner's confidence file: clamp to [0, 1], x65535, as uint16."""
    return (np.clip(conf, np.float32(0.0), np.float32(1.0))
            * np.float32(65535.0)).astype(np.uint16)


def write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + rgb.astype(np.uint8)
                .tobytes())


def write_pgm16(path: str, u16: np.ndarray) -> None:
    h, w = u16.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n65535\n".encode()
                + u16.astype(">u2").tobytes())


def read_pgm16(path: str) -> np.ndarray:
    """A 16-bit binary PGM as the runner writes it (no comments)."""
    data = open(path, "rb").read()
    magic, w, h, maxval = data.split(maxsplit=4)[:4]
    if magic != b"P5" or maxval != b"65535":
        raise ValueError(f"{path}: not a 16-bit PGM")
    w, h = int(w), int(h)
    pixels = data[len(data) - 2 * w * h:]
    return np.frombuffer(pixels, ">u2").reshape(h, w).astype(np.uint16)


def seeded_pair(seed: int, frame: tuple) -> tuple[np.ndarray, np.ndarray]:
    """A uint8 image of ``frame`` from ``seed`` and its roll by ``SHIFT``
    columns to the left (tools/pjrt_e2e.py's pair)."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (*frame, 3), dtype=np.uint8)
    return left, np.roll(left, -SHIFT, axis=1)


def export_flags(args) -> list[str]:
    """The export CLI's flags for this run's model."""
    flags = ["--backbone", args.backbone, "--cv_scale", str(args.cv_scale),
             "--cv", args.cv, "--dtype", args.dtype, "--maxdisp",
             str(args.maxdisp), "--height", str(args.height), "--width",
             str(args.width)]
    if args.loadckpt:
        flags += ["--loadckpt", args.loadckpt]
    if args.confidence:
        flags.append("--confidence")
    return flags


def export(args, prefix: str) -> dict:
    """``cli/export.py``'s ``main`` on the card: its seconds and the
    package's path and bytes."""
    from esmstereo_tpu_torch.cli import export as export_cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = export_cli.main([*export_flags(args), "--out", prefix])
    text = out.getvalue()
    m = COMPILE_RE.search(text)
    if rc != 0 or not m:
        raise RuntimeError(f"export failed (rc={rc}):\n{text}")
    path = prefix + ".pt2"
    return {"export_s": float(m.group(1)), "save_s": float(m.group(2)),
            "compile_s": float(m.group(3)), "package": path,
            "package_bytes": os.path.getsize(path), "log": text}


def run_runner(binary: str, argv: list, timeout: float = 900) -> dict:
    """The runner on ``argv``: its JSON line and its stderr. Raises unless
    it exits 0."""
    proc = subprocess.run([binary, *argv], capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"stereo_infer exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                stderr=proc.stderr)


@contextlib.contextmanager
def serving_numerics():
    """The runner's settings in this process: TF32 off, cuDNN
    deterministic."""
    from esmstereo_tpu_torch.eval.runner import fp32_precision
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad(), fp32_precision():
            yield
    finally:
        torch.backends.cudnn.deterministic = before


def maps(out) -> list[np.ndarray]:
    """A program's output (a tensor, or a pair) as float32 (H, W) maps."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o[0].float().cpu().numpy() for o in outs]


def eager_model(args):
    """The model ``export`` exported, built again for the eager path."""
    from esmstereo_tpu_torch.cli.common import build_config
    from esmstereo_tpu_torch.models import build_model
    from esmstereo_tpu_torch.train.checkpoints import load_weights

    name = "ESMStereo_confidence" if args.confidence else "ESMStereo"
    model = build_model(name, build_config(args), device="cuda")
    if args.loadckpt:
        load_weights(args.loadckpt, model)
    return model.eval()


def serve(args, workdir: str, frame: tuple) -> dict:
    """Export, build, serve a ``frame`` pair with the runner, and run the
    package in Python and the eager path on the same inputs. Returns the
    numbers and the maps: ``runner`` (its JSON: ms a frame, launches,
    runs), ``runner_u16`` / ``golden_u16`` (and ``runner_conf16`` /
    ``golden_conf16``), ``package`` and ``eager`` raw maps, ``inputs``,
    and the package run's launch counts a frame (``python_launches``)."""
    from esmstereo_tpu_torch.ops.kernels import torch_ops
    from esmstereo_tpu_torch.serving import build

    if not torch.cuda.is_available():
        raise RuntimeError("serve_e2e runs on a CUDA card")
    result = export(args, os.path.join(workdir, "StereoModel"))
    t0 = time.perf_counter()
    binary = str(build.build())
    result["runner_build_s"] = time.perf_counter() - t0

    left, right = seeded_pair(args.seed, frame)
    paths = {k: os.path.join(workdir, f"{k}.{ext}") for k, ext in (
        ("left", "ppm"), ("right", "ppm"), ("gt", "pgm"), ("disp", "pgm"),
        ("conf", "pgm"))}
    write_ppm(paths["left"], left)
    write_ppm(paths["right"], right)
    write_pgm16(paths["gt"], np.full(frame, SHIFT * 256, np.uint16))
    argv = ["--model", result["package"], "--left", paths["left"],
            "--right", paths["right"], "--out", paths["disp"], "--height",
            str(args.height), "--width", str(args.width), "--max_disp",
            str(args.maxdisp), "--gt", paths["gt"], "--frames",
            str(args.frames), "--warmup", str(args.warmup)]
    if args.confidence:
        argv += ["--conf_out", paths["conf"]]
    result["runner"] = run_runner(binary, argv)
    result["runner_u16"] = read_pgm16(paths["disp"])

    inputs = [preprocess(im, args.height, args.width) for im in (left, right)]
    result["inputs"] = inputs
    dev = [torch.from_numpy(x).cuda() for x in inputs]
    program = torch._inductor.aoti_load_package(result["package"])
    with serving_numerics():
        torch_ops.reset_op_launches()
        result["package_maps"] = maps(program(*dev))
        torch.cuda.synchronize()
        result["python_launches"] = torch_ops.op_launches()
        result["eager_maps"] = maps(eager_model(args)(*dev))
    golden = postprocess(result["package_maps"][0], frame, args.maxdisp,
                         *result["package_maps"][1:])
    if args.confidence:
        golden, conf = golden
        result["golden_conf16"] = confidence_u16(conf)
        result["runner_conf16"] = read_pgm16(paths["conf"])
    result["golden_u16"] = golden
    return result


def summary(result: dict) -> dict:
    """The JSON-able verdict of ``serve``: the runner against the package
    bit for bit, the package against eager, the numbers."""
    same = bool(np.array_equal(result["runner_u16"], result["golden_u16"]))
    if "golden_conf16" in result:
        same &= bool(np.array_equal(result["runner_conf16"],
                                    result["golden_conf16"]))
    eager = {}
    for i, (p, e) in enumerate(zip(result["package_maps"],
                                   result["eager_maps"])):
        peak = float(np.abs(e).max())
        eager[("disparity", "confidence")[i]] = {
            "max_abs": float(np.abs(p - e).max()),
            "mean_abs": float(np.abs(p - e).mean()), "max_abs_eager": peak}
    runs = result["runner"]["runs"]
    return {"ok": same, "runner_bit_for_bit": same,
            "package_vs_eager": eager,
            "launches_per_frame": {k: v / runs for k, v in
                                   result["runner"]["launches"].items()},
            "python_launches": result["python_launches"],
            **{k: result[k] for k in ("export_s", "save_s", "compile_s",
                                      "package_bytes", "runner_build_s")},
            "runner": {k: v for k, v in result["runner"].items()
                       if k != "stderr"},
            "device": torch.cuda.get_device_name(0)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="native serving end-to-end "
                                            "golden run (PyTorch port)")
    p.add_argument("--backbone", default="efficientnet_b2",
                   choices=["mobilenetv2_100", "efficientnet_b2"])
    p.add_argument("--cv_scale", type=int, default=4, choices=[16, 8, 4])
    p.add_argument("--cv", default="gwc",
                   choices=["norm_correlation", "gwc"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--confidence", action="store_true")
    p.add_argument("--loadckpt", default="")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--frame", default="375,1242",
                   help="the served pair's H,W, padded to --height/--width")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--out_json", default="")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    frame = tuple(int(v) for v in args.frame.split(","))
    with tempfile.TemporaryDirectory() as workdir:
        result = summary(serve(args, workdir, frame))
    text = json.dumps(result)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
