"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>-<hash>.so`` (``-gencode arch=compute_90a,code=sm_90a``),
loaded with ``ctypes``. The hash covers the source and the headers of
``csrc/``, so an edited source is rebuilt and an unchanged one is reused.
A library is built at its first use; ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them (what ``chip_smoke.py`` does).
Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("fused_head", "correlation", "fused_volume_agg", "fused_hourglass",
           "fused_stems", "fused_mixer", "fused_stage", "activations_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    rc = proc.wait()
    log = out.with_suffix(".log")
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={rc}):\n"
                           + log.read_text())
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source in parallel;
    return ``{name: path}``. Raises on the first failed build, after every
    compiler process has ended."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name``."""
    log = lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(ln.strip() for ln in log.read_text().splitlines()
                     if ("ptxas info" in ln and "Used" in ln) or "spill" in ln)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
