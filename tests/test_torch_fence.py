"""Import fence: the PyTorch port and chip_smoke.py import no JAX, and
nothing the card's machine lacks.

Parses every ``.py`` file of ``esmstereo_tpu_torch/`` and ``chip_smoke.py``
with ``ast`` and fails on any import of ``jax``, ``flax``, ``jaxlib`` or
``esmstereo_tpu`` (the JAX package), of ``tools`` (the JAX CLIs), or of
``PIL`` or ``cv2`` (the port reads and writes PNG files itself,
``data/png.py``), at any depth of the file. The port's C++ and CUDA
sources, and the two sources of ``serving/src/`` its runner compiles in,
include no OpenCV, PJRT or XLA header.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "jaxlib", "esmstereo_tpu", "tools", "PIL", "cv2"}
FILES = sorted((ROOT / "esmstereo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
NATIVE = sorted(p for ext in ("*.cc", "*.cpp", "*.cu", "*.cuh", "*.h")
                for p in (ROOT / "esmstereo_tpu_torch").rglob(ext)) + [
    ROOT / "serving" / "src" / "stereo_pipeline.cc",
    ROOT / "serving" / "src" / "stereo_eval.cc"]
FORBIDDEN_HEADERS = re.compile(r"#\s*include\s*[<\"](opencv|pjrt|xla)",
                               re.IGNORECASE)


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_fence_covers_the_port():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fence_catches_a_jax_import():
    tree = ast.parse("import os\nfrom esmstereo_tpu.ops import x\n"
                     "def f():\n    import jax.numpy as jnp\n")
    found = {m.split(".")[0] for m in _imports(tree)}
    assert {"esmstereo_tpu", "jax"} <= found


def test_fence_catches_image_libraries_and_tools():
    tree = ast.parse("from PIL import Image\nimport tools.common\n"
                     "def f():\n    import cv2\n")
    found = {m.split(".")[0] for m in _imports(tree)}
    assert {"PIL", "tools", "cv2"} <= found <= FORBIDDEN


@pytest.mark.parametrize("path", NATIVE, ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_include_no_forbidden_headers(path):
    bad = FORBIDDEN_HEADERS.findall(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} includes {bad}"


def test_native_fence_catches_a_forbidden_header():
    assert FORBIDDEN_HEADERS.search('#include <opencv2/opencv.hpp>')
    assert FORBIDDEN_HEADERS.search('#include "pjrt_runner.h"')
    assert not FORBIDDEN_HEADERS.search('#include "stereo_pipeline.h"')
