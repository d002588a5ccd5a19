"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>-<hash>.so`` (``-gencode arch=compute_90a,code=sm_90a``),
loaded with ``ctypes``. The hash covers the source and the headers of
``csrc/``, so an edited source is rebuilt and an unchanged one is reused.
A library is built at its first use; ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them (what ``chip_smoke.py`` does).
Nothing runs at import.

Two more libraries are C++ against the installed torch wheel (its
``include/`` and ``lib/``, its C++ ABI), built with the same ``nvcc``:

  * ``libesmstereo_ops-<hash>.so``: ``csrc/torch_ops.cpp``, the CUDA
    kernels of the ``esmstereo::`` operators (``torch_ops.py``), linked to
    the kernel libraries it calls (``OPS_KERNELS``); compiled while the
    kernels compile, linked after them;
  * ``libesmstereo_defs-<hash>.so``: the operators' schemas, from the C++
    source ``torch_ops.defs_source()`` generates into ``_build/``, for a
    process without Python (the runner of ``serving/``).

Their hash also covers the torch version, the compiler flags and, for the
ops library, the kernel libraries' paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("fused_head", "correlation", "fused_volume_agg", "fused_hourglass",
           "fused_stems", "fused_mixer", "fused_stage", "activations_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernel libraries csrc/torch_ops.cpp calls, and the two torch targets
OPS_KERNELS = ("fused_head", "correlation", "fused_hourglass")
OPS, DEFS = "esmstereo_ops", "esmstereo_defs"

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


def torch_dirs() -> tuple[Path, Path]:
    """The installed torch wheel's ``include/`` and ``lib/``."""
    root = Path(torch.__file__).resolve().parent
    return root / "include", root / "lib"


def torch_flags() -> list[str]:
    """Compiler flags for C++ against the torch wheel: its headers and its
    C++ ABI."""
    inc, _ = torch_dirs()
    abi = int(torch.compiled_with_cxx11_abi())
    return ["-std=c++17", "-O2", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            "-I", str(inc), "-I", str(inc / "torch" / "csrc" / "api" /
                                      "include")]


def torch_libs(*names: str) -> list[str]:
    """Linker flags for the torch wheel's libraries ``names``, found at run
    time by rpath."""
    _, lib = torch_dirs()
    return ["-L", str(lib), "-Xlinker", f"-rpath={lib}",
            *(f"-l{n}" for n in names)]


def _torch_hash(*parts: str) -> str:
    h = hashlib.sha256()
    for part in (torch.__version__, " ".join(torch_flags()), *parts):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def defs_path() -> Path:
    from esmstereo_tpu_torch.ops.kernels import torch_ops
    return BUILD_DIR / f"lib{DEFS}-{_torch_hash(torch_ops.defs_source())}.so"


def ops_path() -> Path:
    kernels = [str(lib_path(n)) for n in OPS_KERNELS]
    src = (CSRC / "torch_ops.cpp").read_text()
    return BUILD_DIR / f"lib{OPS}-{_torch_hash(src, *kernels)}.so"


def _run(cmd: list, log: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as fh:
        return subprocess.Popen([str(c) for c in cmd], stdout=fh,
                                stderr=subprocess.STDOUT)


def _wait(proc: subprocess.Popen, log: Path, what: str) -> None:
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"{what} failed (rc={rc}):\n" + log.read_text())


def _start_torch() -> dict:
    """Start the torch targets that are missing: the definitions library
    (compiled and linked) and the ops library's object (linked by
    ``_finish_torch``, once the kernel libraries exist)."""
    from esmstereo_tpu_torch.ops.kernels import torch_ops
    started = {}
    defs, ops = defs_path(), ops_path()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", *torch_flags(),
             "-Xcompiler", "-fPIC"]
    if not defs.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = defs.with_suffix(".cpp")
        src.write_text(torch_ops.defs_source())
        tmp = defs.with_suffix(f".{os.getpid()}.tmp")
        started[DEFS] = (_run([_nvcc(), *flags, "-shared", "-o", tmp, src,
                               *torch_libs("c10", "torch_cpu")],
                              defs.with_suffix(".log")), tmp, defs)
    if not ops.exists():
        obj = ops.with_suffix(f".{os.getpid()}.o")
        started[OPS] = (_run([_nvcc(), *flags, "-c", "-o", obj,
                              CSRC / "torch_ops.cpp"],
                             ops.with_suffix(".log")), obj, ops)
    return started


def _finish_torch(started: dict) -> None:
    """Wait for the torch targets; link the ops library to the kernel
    libraries (by path) and the torch wheel's."""
    errors = []
    for name, (proc, _, out) in started.items():
        try:
            _wait(proc, out.with_suffix(".log"), f"nvcc for {name}")
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    if DEFS in started:
        _, tmp, out = started[DEFS]
        os.replace(tmp, out)
    if OPS in started:
        _, obj, out = started[OPS]
        log = out.with_suffix(".link.log")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _wait(_run([_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", tmp, obj,
                    *map(lib_path, OPS_KERNELS),
                    *torch_libs("c10", "c10_cuda", "torch_cpu",
                                "torch_cuda")], log), log, f"linking {OPS}")
        os.replace(tmp, out)
        obj.unlink()


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library of ``names`` and of the kernels the ops
    library links, one ``nvcc`` per source and one per torch target in
    parallel; return ``{name: path}``, the kernel libraries and then the
    ops and definitions libraries. Raises on the first failed build, after
    every compiler process has ended."""
    names = tuple(dict.fromkeys((*names, *OPS_KERNELS)))
    started = {n: _start(n) for n in names}
    torch_started = _start_torch()
    errors = []
    for n, s in started.items():
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        for proc, _, _ in torch_started.values():
            proc.wait()
    else:
        try:
            _finish_torch(torch_started)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {**{n: lib_path(n) for n in names}, OPS: ops_path(),
            DEFS: defs_path()}


def build_ops() -> dict[str, Path]:
    """The ops and definitions libraries and the kernel libraries the ops
    library links, built where missing."""
    with _lock:
        return build_all(OPS_KERNELS)


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
