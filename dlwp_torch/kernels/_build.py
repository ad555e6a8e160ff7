"""Build the hand-written kernels at first use and load them.

Each ``dlwp_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own by ``nvcc`` into a shared library under
``dlwp_torch/kernels/_build/`` (listed in ``.gitignore``), then loaded with
``ctypes``. Each ``csrc/<name>.c`` (a host kernel, such as the batch
gather) is compiled the same way by the host C compiler (``cc -O3 -fPIC
-shared -pthread``). The library name carries a hash of the source, for
CUDA sources the shared headers (``csrc/*.cuh``), and the flags, so an
edited source or header is rebuilt and a current one is reused. Sources
build in parallel: one compiler process each, all started together.

Nothing here runs at import time; the CPU-only test environment imports
every module and has no ``nvcc`` (it has a C compiler, so the host
kernels build and run in its tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CC_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c11"]

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cc_path() -> str | None:
    """The host C compiler (``$CC``, else ``cc``, else ``gcc``), or None
    where there is none."""
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def sources() -> list[str]:
    """The CUDA kernels' names (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> list[str]:
    """The host kernels' names (``csrc/*.c``)."""
    return sorted(p.stem for p in CSRC.glob("*.c"))


def source_path(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.c"


def _command(name: str, out: Path) -> list[str]:
    src = source_path(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    cc = cc_path()
    if cc is None:
        raise RuntimeError("no C compiler found: set CC or put cc on PATH")
    return [cc, *CC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu`` (or ``.c``), named by a hash of
    that source, for a CUDA source every shared header (``csrc/*.cuh``),
    and the flags."""
    src = source_path(name)
    digest = hashlib.sha1(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode())
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> float:
    """Compile every listed source (default: every CUDA and host kernel)
    whose library is missing;
    returns the wall seconds spent. The compiler's output (for CUDA
    sources ``nvcc``'s ``-Xptxas -v`` report: registers, shared memory,
    spills) is kept beside each library as ``.log``; a failed build
    raises with it."""
    names = sources() + host_sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((n, out, tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{source_path(n).name} ({proc.args[0]} exit "
                          f"{proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.c``), built first
    if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
