"""The port's command-line entry points (``esmstereo_tpu_torch/cli``), on
the CPU.

Each CLI's ``main([... "--cpu"])`` runs in this process at S
(``--backbone mobilenetv2_100 --cv_scale 16 --maxdisp 64``, seeded random
weights) on tiny synthetic trees, the shapes ``tests/test_tools_cli.py``
gives their JAX twins (62x94 and 94x158 images, padded and cropped by the
runner), with the same checks: exit code 0, finite metrics, the
checkpoints and PNGs. Besides: each port parser has exactly the option
strings, defaults, choices and types of its JAX parser (collected by
running the JAX ``parse_args`` under a patched
``argparse.ArgumentParser.parse_args``: no subprocess, no JAX model);
``masked_epe_and_rate`` against JAX's; ``load_model_for_eval`` restoring
what ``run_training`` saved; ``save_disp``'s uint16 PNGs equal to the
runner's output, read back through the port's decoder.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from esmstereo_tpu.eval import runner as jrunner  # noqa: E402
from esmstereo_tpu_torch.cli import (export, make_filelists,  # noqa: E402
                                     save_disp, test_eth3d, test_kitti,
                                     test_mid, train_kitti, train_sceneflow)
from esmstereo_tpu_torch.cli.common import build_config  # noqa: E402
from esmstereo_tpu_torch.data import png  # noqa: E402
from esmstereo_tpu_torch.data.io import pfm_imwrite  # noqa: E402
from esmstereo_tpu_torch.eval import runner  # noqa: E402
from esmstereo_tpu_torch.nn import blocks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
S_ARGS = ["--cpu", "--backbone", "mobilenetv2_100", "--cv_scale", "16",
          "--maxdisp", "64"]
CLIS = {"make_filelists": make_filelists, "train_sceneflow": train_sceneflow,
        "train_kitti": train_kitti, "test_kitti": test_kitti,
        "save_disp": save_disp, "test_mid": test_mid,
        "test_eth3d": test_eth3d, "export": export}
# the JAX CLI of each port CLI whose name differs
JAX_TOOLS = {"export": "export_stablehlo"}


def _run(cli, *args: str) -> str:
    """``cli.main(args)`` in this process: its stdout, after exit 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(args))
    assert rc == 0, out.getvalue()[-2000:]
    return out.getvalue()


def _rand_png(path, rng: np.random.Generator, shape=(62, 94, 3)) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(path)


def _disp_png16(path, rng: np.random.Generator, shape=(62, 94)) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    disp = rng.uniform(1.0, 40.0, shape).astype(np.float32)
    disp[:, :3] = 0.0  # invalid pixels
    Image.fromarray((disp * 256).astype(np.uint16)).save(path)


def _finite_numbers(pattern: str, out: str) -> list[float]:
    nums = [float(x) for x in re.findall(pattern, out, re.IGNORECASE)]
    assert nums and all(np.isfinite(n) for n in nums), out[-2000:]
    return nums


@pytest.fixture(scope="module")
def kitti15_tree(tmp_path_factory):
    """KITTI-2015 layout: ``root/training/{image_2,image_3,disp_occ_0}``
    (the eval CLIs take ``training/`` as --datapath, make_filelists the
    root)."""
    root = tmp_path_factory.mktemp("kitti15")
    rng = np.random.default_rng(1)
    for name in ("000000_10.png", "000001_10.png"):
        _rand_png(root / "training" / "image_2" / name, rng)
        _rand_png(root / "training" / "image_3" / name, rng)
        _disp_png16(root / "training" / "disp_occ_0" / name, rng)
    return root


@pytest.fixture(scope="module")
def scene_tree(tmp_path_factory):
    """ETH3D/Middlebury layout: scene dirs with im0/im1, PFM GT (an inf
    entry, the invalid marker) and a non-occlusion mask."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(3)
    for scene in ("sceneA", "sceneB"):
        d = root / scene
        _rand_png(d / "im0.png", rng, shape=(64, 96, 3))
        _rand_png(d / "im1.png", rng, shape=(64, 96, 3))
        disp = rng.uniform(1.0, 30.0, (64, 96)).astype(np.float32)
        disp[0, 0] = np.inf
        pfm_imwrite(str(d / "disp0GT.pfm"), disp)
        mask = np.full((64, 96), 255, np.uint8)
        mask[:8] = 128  # occluded band
        Image.fromarray(mask).save(d / "mask0nocc.png")
    return root


@pytest.fixture(scope="module")
def sceneflow_run(tmp_path_factory):
    """One epoch of the SceneFlow recipe at S on a 4-pair tree in the
    FlyingThings3D layout, its list written by ``make_filelists``:
    (stdout, logdir)."""
    root = tmp_path_factory.mktemp("sceneflow")
    rng = np.random.default_rng(4)
    for i in range(4):
        rel = os.path.join("TRAIN", "A", f"{i:04d}")
        for eye in ("left", "right"):
            _rand_png(root / "frames_finalpass" / rel / eye / "0006.png", rng,
                      shape=(64, 96, 3))
        os.makedirs(root / "disparity" / rel / "left")
        pfm_imwrite(str(root / "disparity" / rel / "left" / "0006.pfm"),
                    rng.uniform(1, 40, (64, 96)).astype(np.float32))
    listfile = root / "train.txt"
    with contextlib.redirect_stderr(io.StringIO()):
        _run(make_filelists, "sceneflow_train", str(root), "-o",
             str(listfile))
    assert len(listfile.read_text().split("\n")) == 5
    logdir = root / "logs"
    out = _run(train_sceneflow, *S_ARGS, "--datapath", str(root),
               "--trainlist", str(listfile), "--testlist", str(listfile),
               "--epochs", "1", "--batch_size", "2", "--test_batch_size", "2",
               "--num_workers", "1", "--crop", "64,96", "--eval_crop",
               "64,96", "--logdir", str(logdir))
    return out, logdir


def test_test_kitti_cli(kitti15_tree, tmp_path):
    out = _run(test_kitti, *S_ARGS, "--datapath",
               str(kitti15_tree / "training"), "--limit", "2", "--save_dir",
               str(tmp_path / "viz"))
    m = re.search(r"#### EPE ([-\d.eE]+)", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    assert len(re.findall(r"^\[\d/2\] 00000\d_10\.png EPE ", out, re.M)) == 2
    for sub in ("error", "gt", "disp"):
        files = sorted(os.listdir(tmp_path / "viz" / sub))
        assert files == ["000000_10.png", "000001_10.png"]
        img = np.array(Image.open(tmp_path / "viz" / sub / files[0]))
        assert img.shape == (62, 94, 3) and img.dtype == np.uint8


def test_save_disp_cli(kitti15_tree, tmp_path):
    """The uint16 PNGs are round(clip(pred, 0, 255) * 256) of the runner's
    output on the same weights, read back by the port's decoder and by
    PIL."""
    outdir = tmp_path / "preds"
    out = _run(save_disp, *S_ARGS, "--datapath",
               str(kitti15_tree / "training"), "--outdir", str(outdir))
    assert "wrote 2 predictions" in out
    files = sorted(os.listdir(outdir))
    assert files == ["000000_10.png", "000001_10.png"]
    args = save_disp.build_parser().parse_args(
        [*S_ARGS, "--datapath", "unused"])
    run = runner.InferenceRunner(runner.load_model_for_eval(
        build_config(args), device="cpu"))
    for name in files:
        img = kitti15_tree / "training"
        pred, _ = run(png.read_rgb(str(img / "image_2" / name)),
                      png.read_rgb(str(img / "image_3" / name)))
        want = np.round(np.clip(pred, 0, 255) * 256).astype(np.uint16)
        got = png.read_png(str(outdir / name))
        assert got.dtype == np.uint16 and got.shape == (62, 94)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.array(Image.open(outdir / name)),
                                      want)


@pytest.mark.parametrize("cli", [test_mid, test_eth3d],
                         ids=["test_mid", "test_eth3d"])
def test_scene_eval_clis(cli, scene_tree):
    out = _run(cli, *S_ARGS, "--datapath", str(scene_tree), "--limit", "2")
    assert len(_finite_numbers(r"EPE\D*?([\d.]+)", out)) == 3, out
    _finite_numbers(r"bad\D*?([\d.]+)", out)


def test_train_sceneflow_cli(sceneflow_run):
    out, logdir = sceneflow_run
    assert "best:" in out, out[-2000:]
    assert "checkpoint_000000" in os.listdir(logdir), os.listdir(logdir)
    _finite_numbers(r"\| EPE ([-\d.eE]+)", out)


def test_load_model_for_eval_restores_training(sceneflow_run):
    """``load_model_for_eval`` restores every tensor ``run_training``
    saved, and ``test_kitti --loadckpt`` serves it."""
    _, logdir = sceneflow_run
    path = str(logdir / "checkpoint_000000")
    args = test_kitti.build_parser().parse_args(
        [*S_ARGS, "--datapath", "unused"])
    model = runner.load_model_for_eval(build_config(args), path, "cpu")
    assert not model.training
    saved = torch.load(path, map_location="cpu", weights_only=True)["model"]
    got = model.state_dict()
    assert list(got) == list(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    fresh = runner.load_model_for_eval(build_config(args), device="cpu")
    assert any(not torch.equal(fresh.state_dict()[k], v)
               for k, v in saved.items())


def test_test_kitti_loadckpt(kitti15_tree, sceneflow_run):
    _, logdir = sceneflow_run
    out = _run(test_kitti, *S_ARGS, "--datapath",
               str(kitti15_tree / "training"), "--limit", "1", "--loadckpt",
               str(logdir / "checkpoint_000000"))
    _finite_numbers(r"#### EPE ([-\d.eE]+)", out)


def test_train_kitti_cli(tmp_path):
    """One epoch of the KITTI finetune on a 2015 tree (94x158: the eval
    pads to --pad_to), its list from make_filelists, capped by
    --max_batches, with a checkpoint."""
    rng = np.random.default_rng(5)
    root = tmp_path / "kitti"
    for name in ("000000_10.png", "000001_10.png", "000002_10.png",
                 "000003_10.png"):
        for side in ("image_2", "image_3"):
            _rand_png(root / "training" / side / name, rng,
                      shape=(94, 158, 3))
        _disp_png16(root / "training" / "disp_occ_0" / name, rng,
                    shape=(94, 158))
    listfile = tmp_path / "kitti15_all.txt"
    with contextlib.redirect_stderr(io.StringIO()):
        _run(make_filelists, "kitti15", str(root), "-o", str(listfile))
    logdir = tmp_path / "logs"
    out = _run(train_kitti, *S_ARGS, "--datapath_12", str(root),
               "--datapath_15", str(root), "--trainlist", str(listfile),
               "--testlist", str(listfile), "--epochs", "1", "--batch_size",
               "2", "--test_batch_size", "2", "--num_workers", "1", "--crop",
               "64,96", "--pad_to", "96,160", "--max_batches", "1",
               "--logdir", str(logdir), "--save_freq", "1")
    assert "best:" in out, out[-2000:]
    assert re.findall(r"\| Iter \d/\d \|", out) == ["| Iter 0/1 |"], out
    assert "checkpoint_000000" in os.listdir(logdir)


def test_make_filelists_cli(kitti15_tree, tmp_path):
    listfile = tmp_path / "kitti15_all.txt"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _run(make_filelists, "kitti15", str(kitti15_tree), "-o",
             str(listfile))
    assert "wrote 2 entries" in err.getvalue()
    lines = listfile.read_text().strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        parts = line.split()
        assert len(parts) == 3
        assert parts[0].startswith("training/image_2/")
        assert parts[2].startswith("training/disp_occ_0/")
    # kitti12 and kitti_raw layouts
    raw = tmp_path / "raw"
    _rand_png(raw / "image_02" / "data" / "0000000000.png",
              np.random.default_rng(6), shape=(4, 4, 3))
    out = _run(make_filelists, "kitti_raw", str(raw))
    assert out == ("image_02/data/0000000000.png "
                   "image_03/data/0000000000.png\n")


def test_masked_epe_and_rate_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.uniform(0, 50, (31, 47)).astype(np.float32)
    gt = rng.uniform(0, 50, (31, 47)).astype(np.float32)
    for mask in (gt > 10, np.zeros_like(gt, bool), np.ones_like(gt, bool)):
        for thresh in (1.0, 3.0):
            assert runner.masked_epe_and_rate(pred, gt, mask, thresh) == \
                jrunner.masked_epe_and_rate(pred, gt, mask, thresh)


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _jax_parser(name: str) -> argparse.ArgumentParser:
    """The parser ``tools/<name>.py`` builds, caught at its
    ``parse_args``."""
    sys.path.insert(0, TOOLS)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        def caught(self, *args, **kwargs):
            raise _Parsed(self)

        with mock.patch.object(argparse.ArgumentParser, "parse_args",
                               caught):
            with pytest.raises(_Parsed) as info:
                getattr(mod, "parse_args", mod.main)()
    finally:
        sys.path.remove(TOOLS)
    return info.value.parser


def _options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings) or a.dest:
            (a.dest, a.default, a.choices, a.type, a.required, a.nargs,
             type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_matches_jax(name):
    """Every option string of the JAX CLI, with its default, choices,
    type and action, and none of the port's own."""
    want = _options(_jax_parser(JAX_TOOLS.get(name, name)))
    got = _options(CLIS[name].build_parser())
    assert got == want


def test_clis_refuse_without_card_or_cpu(kitti15_tree):
    """Without ``--cpu`` a CLI runs on the card, and raises without one;
    ``--spatial_shards`` > 1 raises until multi-GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        test_kitti.main([*S_ARGS[1:], "--datapath",
                         str(kitti15_tree / "training")])
    with pytest.raises(RuntimeError, match="CUDA"):
        export.main([*S_ARGS[1:], "--height", "64", "--width", "96"])
    with pytest.raises(NotImplementedError, match="spatial_shards"):
        train_sceneflow.main([*S_ARGS, "--spatial_shards", "2"])


def test_runtime_flags_restored(kitti15_tree):
    """``--fast_gelu`` and ``--debug_nans`` hold for the run only."""
    from esmstereo_tpu_torch.cli.common import apply_runtime_flags
    args = train_sceneflow.build_parser().parse_args(
        ["--cpu", "--fast_gelu", "--debug_nans"])
    assert not blocks.GELU_APPROXIMATE and not torch.is_anomaly_enabled()
    with apply_runtime_flags(args) as device:
        assert device == torch.device("cpu")
        assert blocks.GELU_APPROXIMATE and torch.is_anomaly_enabled()
    assert not blocks.GELU_APPROXIMATE and not torch.is_anomaly_enabled()
    assert build_config(train_sceneflow.build_parser().parse_args(
        ["--dtype", "bfloat16"])).dtype == "bfloat16"


def test_clis_run_as_modules():
    """``python -m esmstereo_tpu_torch.cli.<name> --help`` exits 0 for
    each CLI (one interpreter, each module run as ``__main__``)."""
    code = ("import runpy, sys\n"
            f"for name in {sorted(CLIS)!r}:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('esmstereo_tpu_torch.cli.' + name,"
            " run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "    else:\n"
            "        raise AssertionError(name)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("usage:") == len(CLIS)
