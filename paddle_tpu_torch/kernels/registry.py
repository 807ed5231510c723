"""Hand-written kernels: launch counters, the plain-reference switch and
the build step.

Each CUDA kernel lives in a source under paddle_tpu_torch/csrc/ with a
plain C interface (one source may hold several kernels). At first use a
source is compiled with nvcc for sm_90a into a shared library under
paddle_tpu_torch/_build/ (named by a hash of the source, the shared
headers and the flags, so an edit rebuilds) and loaded with ctypes.
Nothing is built when a module is imported: this module imports on
machines with no nvcc and no card.

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
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "flash_attention_bwd.cu",
    "fused_adam": "fused_optimizer.cu",
}

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
    """The shared library of kernel `name` (that of its source)."""
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names=None) -> Dict[str, float]:
    """Compile the sources of the named kernels (default: all) that are
    not built yet, one nvcc process per source, all started together.
    Returns seconds per source built (by source stem); raises with
    nvcc's output if one fails. The compiler's register/shared-memory
    report goes to _build/<source stem>.log."""
    names = list(SOURCES if names is None else names)
    todo = {}
    for n in names:
        path, src = library_path(n), CSRC / SOURCES[n]
        if not path.exists():
            todo[src.stem] = (path, src)
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, (path, src) in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[n] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, failed = {}, []
    for n, (path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, path)  # atomic: no half-written .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel's source, built at first
    use. Loaded once per process: later calls read no file (a launch on
    the hot path must not hash the sources again)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        path = library_path(name)
        lib = _libs.get(path.name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(path))
            _libs[path.name] = lib
        _libs[name] = lib
        return lib
