"""Hand-written kernels: launch counters, the plain-reference switch and
the build step.

Each CUDA kernel is one source under paddle_tpu_torch/csrc/ with a plain C
interface. At first use it is compiled with nvcc for sm_90a into a shared
library under paddle_tpu_torch/_build/ (named by a hash of the source and
flags, so an edited source rebuilds) and loaded with ctypes. Nothing is
built when a module is imported: this module imports on machines with no
nvcc and no card.

Each wrapper adds one to its kernel's launch count where it launches the
kernel, and nowhere else, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> its source under csrc/
SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_launches: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_plain_depth = [0]


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def count(name: str):
    _launches[name] += 1


def launches() -> Dict[str, int]:
    return dict(_launches)


def reset_counts():
    for name in _launches:
        _launches[name] = 0


# ---------------------------------------------------------------------------
# plain reference switch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_reference():
    """Inside this context every wrapper runs its plain PyTorch version,
    on CUDA tensors too: the way to hold a whole forward against the same
    forward without the kernels. Nothing on the main path enters it."""
    _plain_depth[0] += 1
    try:
        yield
    finally:
        _plain_depth[0] -= 1


def plain_forced() -> bool:
    return _plain_depth[0] > 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels are built at first use and need the "
        "CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns seconds
    per kernel built; raises with nvcc's output if one fails. The
    compiler's register/shared-memory report goes to
    _build/<name>.log."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, library_path(n))  # atomic: no half-written .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built at first use."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
