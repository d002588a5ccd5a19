"""Build the native runner ``stereo_infer`` with ``g++``.

    python3 -m esmstereo_tpu_torch.serving.build     # prints its path

Compiles ``aoti_runner.cc`` and ``stereo_infer_main.cc`` of this package
with the repository's ``serving/src/stereo_pipeline.cc`` and
``serving/src/stereo_eval.cc`` (by path: the pre- and post-processing and
the evaluation the PJRT runner uses), against the installed torch wheel's
headers and libraries (its C++ ABI), into
``esmstereo_tpu_torch/_build/stereo_infer-<hash>`` at first use. The paths
of the definitions and ops libraries (``ops/kernels/_build.py``), which the
runner loads before it opens a package, are compiled in, and the hash
covers them, the sources and the flags. ``start`` and ``finish`` split the
build so that it can run beside the kernels' (``chip_smoke.py``).
Nothing runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from esmstereo_tpu_torch.ops.kernels import _build

HERE = Path(__file__).resolve().parent
REPO_SERVING = _build.PACKAGE_DIR.parent / "serving"
SOURCES = (HERE / "aoti_runner.cc", HERE / "stereo_infer_main.cc",
           REPO_SERVING / "src" / "stereo_pipeline.cc",
           REPO_SERVING / "src" / "stereo_eval.cc")
HEADERS = (HERE / "aoti_runner.h", REPO_SERVING / "include" /
           "stereo_pipeline.h", REPO_SERVING / "include" / "stereo_eval.h")
CUDA_INCLUDE = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "include"


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the runner builds with g++")
    return found


def _command(out: Path) -> list[str]:
    libs = _build.defs_path(), _build.ops_path()
    return [_cxx(), *_build.torch_flags(), "-I", str(CUDA_INCLUDE), "-I",
            str(HERE), "-I", str(REPO_SERVING / "include"),
            f'-DESMSTEREO_DEFS_LIB="{libs[0]}"',
            f'-DESMSTEREO_OPS_LIB="{libs[1]}"', "-o", str(out),
            *map(str, SOURCES),
            *_build.torch_libs("torch", "torch_cpu", "torch_cuda", "c10",
                               "c10_cuda"), "-ldl"]


def runner_path() -> Path:
    """Where the runner of these sources, flags and libraries goes."""
    h = hashlib.sha256()
    for part in _command(Path("stereo_infer")):
        h.update(part.encode())
    for f in (*SOURCES, *HEADERS):
        h.update(f.read_bytes())
    return _build.BUILD_DIR / f"stereo_infer-{h.hexdigest()[:16]}"


def start():
    """Start ``g++`` for a missing runner; the handle for ``finish``."""
    out = runner_path()
    if out.exists():
        return None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(_command(tmp), stdout=fh,
                                stderr=subprocess.STDOUT)
    return proc, tmp, out


def finish(started) -> Path:
    """Wait for ``start``'s build; the runner's path. Raises if it
    failed."""
    if started is not None:
        proc, tmp, out = started
        if proc.wait() != 0:
            raise RuntimeError("g++ failed for stereo_infer:\n"
                               + out.with_suffix(".log").read_text())
        os.replace(tmp, out)
    return runner_path()


def build() -> Path:
    """The runner, built where missing, with the libraries it loads."""
    _build.build_ops()
    return finish(start())


if __name__ == "__main__":
    print(build())
