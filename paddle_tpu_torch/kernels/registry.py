"""Hand-written kernels: the dispatch table, launch counters, the
plain-reference switch and the build step.

Dispatch (counterpart of paddle_tpu/kernels/registry.py). Kernels that
stand in for an op register here with the op types they serve and an
eligibility predicate over the operands' dtypes and shapes. An op
lowering asks :func:`routable` (a cheap pre-gate), then :func:`select`
with the :func:`signature` of its operands, and runs the chosen kernel's
``run`` or keeps its lowered path. Gating, outermost first:

* ``FLAGS_use_custom_kernels`` (core/flags.py), the master switch;
* ``PT_KERNEL_DENY``, kernel names to skip (comma-separated);
* the device: CUDA tensors route; CPU tensors route only while the test
  hook ``_ROUTE_ON_CPU`` is armed (the counterpart of the JAX package's
  ``_INTERPRET``; the selected wrapper then runs its plain version);
  meta tensors (build-time shape inference) never route;
* each kernel's ``eligible(sig)``, which may read ``PT_KERNEL_MIN_NUMEL``
  (:func:`min_numel`) or an opt-in knob. The first eligible kernel wins.

The port has no trace cache, so the knobs are read at each dispatch:
setting one in ``os.environ`` takes effect at the next op. Every
decision made where routing is possible (a CUDA tensor, or a CPU tensor
under the hook) counts once per candidate kernel, as ``custom`` (chosen),
``lowered`` (not eligible) or ``denied`` (flag off or deny list);
:func:`dispatch_stats` reads the counts.

Build. Each CUDA kernel lives in a source under paddle_tpu_torch/csrc/
with a plain C interface (one source may hold several kernels). At first
use a source is compiled with nvcc for sm_90a into a shared library
under paddle_tpu_torch/_build/ (named by a hash of the source, the
shared headers and the flags, so an edit rebuilds) and loaded with
ctypes. Nothing is built when a module is imported: this module imports
on machines with no nvcc and no card.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> its source under csrc/
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "flash_attention_bwd.cu",
    "flash_attention_fwd_sm90": "flash_attention_fwd_sm90.cu",
    "flash_attention_fwd_f32_sm90": "flash_attention_fwd_f32_sm90.cu",
    "flash_attention_bwd_dkv_sm90": "flash_attention_bwd_dkv_sm90.cu",
    "flash_attention_bwd_dq_sm90": "flash_attention_bwd_dq_sm90.cu",
    "fused_adam": "fused_optimizer.cu",
    "fused_sgd": "fused_optimizer.cu",
    "bucket_sweep_adam": "fused_optimizer.cu",
    "bucket_sweep_sgd": "fused_optimizer.cu",
    "quantized_matmul_int8": "quantized_matmul.cu",
    "quantized_matmul_bf16": "quantized_matmul.cu",
    "tuned_matmul": "tuned_matmul.cu",
    "tuned_matmul_ln": "tuned_matmul.cu",
    "tuned_matmul_dr": "tuned_matmul.cu",
    "tuned_matmul_sm90": "tuned_matmul_sm90.cu",
    "tuned_matmul_ln_sm90": "tuned_matmul_sm90.cu",
    "tuned_matmul_dr_sm90": "tuned_matmul_sm90.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_launches: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_plain_depth = [0]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

# Test hook: arm to let the registry route ops on CPU tensors (the
# selected wrapper runs its plain version there).
_ROUTE_ON_CPU = False


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class Signature:
    """The operands a kernel is matched against: dtype names as the JAX
    package writes them ("float32", "bfloat16"), shapes, and the device
    type they lie on."""

    __slots__ = ("op_type", "dtypes", "shapes", "device")

    def __init__(self, op_type: str, dtypes: Tuple[str, ...],
                 shapes: Tuple[Tuple[int, ...], ...], device: str = "cuda"):
        self.op_type = op_type
        self.dtypes = dtypes
        self.shapes = shapes
        self.device = device

    @property
    def numel(self) -> int:
        """Element count of the largest operand."""
        best = 0
        for s in self.shapes:
            n = 1
            for d in s:
                n *= int(d)
            best = max(best, n)
        return best

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Signature({self.op_type!r}, dtypes={self.dtypes!r}, "
                f"shapes={self.shapes!r}, device={self.device!r})")


def signature(op_type: str, *tensors) -> Signature:
    """The Signature of some tensors (None operands are skipped); the
    device is the first tensor's."""
    ts = [t for t in tensors if t is not None]
    return Signature(op_type, tuple(_dtype_name(t.dtype) for t in ts),
                     tuple(tuple(int(d) for d in t.shape) for t in ts),
                     ts[0].device.type if ts else "cpu")


class Kernel:
    """One registered kernel: the op types it serves, its eligibility
    predicate, its entry point ``run(x, y, out_dtype=...)`` and, where it
    has one, ``run_many``: the same over lists of operands in one launch
    (the engine's grouped ops, core/registry.py register_group)."""

    __slots__ = ("name", "op_types", "run", "run_many", "eligible", "doc")

    def __init__(self, name: str, op_types: Tuple[str, ...], run: Callable,
                 eligible: Callable[[Signature], bool], doc: str = "",
                 run_many: Optional[Callable] = None):
        self.name = name
        self.op_types = op_types
        self.run = run
        self.run_many = run_many
        self.eligible = eligible
        self.doc = doc


_KERNELS: Dict[str, Kernel] = {}       # name -> Kernel, in order
_BY_OP: Dict[str, List[Kernel]] = {}   # op type -> kernels, in order
_STATS_LOCK = threading.Lock()
_STATS: Dict[str, Dict[str, int]] = {}  # kernel name -> outcome counts


def register_kernel(name: str, *, op_types: Sequence[str],
                    eligible: Callable[[Signature], bool], run: Callable,
                    doc: str = "",
                    run_many: Optional[Callable] = None) -> Kernel:
    """Register (or re-register) a kernel. A new name goes after those
    already registered for its op types."""
    kern = Kernel(name, tuple(op_types), run, eligible, doc, run_many)
    if name in _KERNELS:
        for lst in _BY_OP.values():
            lst[:] = [k for k in lst if k.name != name]
    _KERNELS[name] = kern
    for op in kern.op_types:
        _BY_OP.setdefault(op, []).append(kern)
    return kern


def unregister_kernel(name: str):
    """Take a kernel out of the table (no-op when it is not there)."""
    _KERNELS.pop(name, None)
    for lst in _BY_OP.values():
        lst[:] = [k for k in lst if k.name != name]


def kernel_names() -> List[str]:
    return list(_KERNELS)


def get(name: str) -> Optional[Kernel]:
    return _KERNELS.get(name)


def candidate_op_types() -> Tuple[str, ...]:
    """Op types with at least one registered kernel, sorted."""
    return tuple(sorted(t for t, ks in _BY_OP.items() if ks))


def min_numel() -> int:
    """Eligibility floor for size-gated kernels (PT_KERNEL_MIN_NUMEL)."""
    from ..tuning import knobs
    return int(knobs.value("kernel_min_numel"))


def _deny() -> Tuple[str, ...]:
    from ..tuning import knobs
    raw = str(knobs.value("kernel_deny") or "")
    return tuple(p.strip() for p in raw.split(",") if p.strip())


def allowed(name: str) -> bool:
    """The flag and deny-list gates for one kernel (no device or shape
    check)."""
    from ..core.flags import FLAGS
    return bool(FLAGS.use_custom_kernels) and name not in _deny()


def _device_routes(device) -> bool:
    kind = getattr(device, "type", device)
    return kind == "cuda" or (kind == "cpu" and _ROUTE_ON_CPU)


def count(name: str, outcome: str):
    """Record one dispatch decision for kernel `name`: ``custom``
    (chosen), ``lowered`` (not eligible) or ``denied`` (flag or deny
    list)."""
    with _STATS_LOCK:
        d = _STATS.setdefault(name, {})
        d[outcome] = d.get(outcome, 0) + 1


def routable(op_type: str, device) -> bool:
    """Cheap pre-gate for lowerings: could :func:`select` route
    `op_type` on `device` (a torch.device or its type) now? Build no
    Signature unless it could."""
    if not _BY_OP.get(op_type):
        return False
    from ..core.flags import FLAGS
    if not FLAGS.use_custom_kernels:
        return False
    return _device_routes(device)


def select(op_type: str, sig: Signature) -> Optional[Kernel]:
    """The kernel to run for `sig`, or None to keep the lowered path.
    The first eligible kernel in registration order wins. Nothing is
    counted where the device cannot route."""
    cands = _BY_OP.get(op_type)
    if not cands or not _device_routes(sig.device):
        return None
    from ..core.flags import FLAGS
    flag_on = bool(FLAGS.use_custom_kernels)
    deny = _deny()
    for kern in cands:
        if not flag_on or kern.name in deny:
            count(kern.name, "denied")
            continue
        if kern.eligible(sig):
            count(kern.name, "custom")
            return kern
        count(kern.name, "lowered")
    return None


def dispatch_stats() -> Dict[str, Any]:
    """Dispatch decisions since the last reset_stats()."""
    with _STATS_LOCK:
        per = {k: dict(v) for k, v in _STATS.items()}
    total = sum(sum(v.values()) for v in per.values())
    custom = sum(v.get("custom", 0) for v in per.values())
    return {"per_kernel": per, "decisions": total, "custom": custom,
            "hit_rate": custom / total if total else 0.0,
            "registered": kernel_names()}


def reset_stats():
    with _STATS_LOCK:
        _STATS.clear()


class _ForwardOnly(torch.autograd.Function):
    """The output of a kernel that has no backward: taking its gradient
    raises instead of yielding zeros (a ctypes launch leaves no autograd
    graph, so without this the gradient would be silently wrong)."""

    @staticmethod
    def forward(ctx, name, fn, *tensors):
        ctx.kernel_name = name
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.kernel_name} is a forward-only kernel: a mul/matmul whose "
            f"gradient the program takes cannot run through it (the JAX "
            f"package refuses the same). Train with PT_KERNEL_QUANT_MATMUL "
            f"unset and no tuned_matmul winner registered, or deny the "
            f"kernel with PT_KERNEL_DENY.")


def forward_only(name: str, fn: Callable, *tensors):
    """fn(*tensors); when autograd records, the result's gradient
    raises (see _ForwardOnly)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return _ForwardOnly.apply(name, fn, *tensors)
    return fn(*tensors)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def count_launch(name: str):
    _launches[name] += 1


def launches() -> Dict[str, int]:
    return dict(_launches)


def reset_counts():
    for name in _launches:
        _launches[name] = 0


def counts_snapshot():
    """The launch counts and the dispatch decisions as they stand."""
    with _STATS_LOCK:
        stats = {k: dict(v) for k, v in _STATS.items()}
    return dict(_launches), stats


def counts_restore(snap):
    """Put the counts of a counts_snapshot() back: what was counted since
    is forgotten (the engine's warm-up and capture runs launch nothing
    that a run counts)."""
    launches, stats = snap
    _launches.update(launches)
    with _STATS_LOCK:
        _STATS.clear()
        _STATS.update({k: dict(v) for k, v in stats.items()})


def counts_delta(before, after):
    """What was counted between two counts_snapshot()s."""
    launches = {k: n - before[0].get(k, 0) for k, n in after[0].items()
                if n != before[0].get(k, 0)}
    stats = {}
    for k, d in after[1].items():
        old = before[1].get(k, {})
        diff = {o: n - old.get(o, 0) for o, n in d.items()
                if n != old.get(o, 0)}
        if diff:
            stats[k] = diff
    return launches, stats


def counts_add(delta):
    """Count a counts_delta() once more: a CUDA-graph replay counts the
    launches and decisions its capture counted."""
    launches, stats = delta
    for k, n in launches.items():
        _launches[k] = _launches.get(k, 0) + n
    with _STATS_LOCK:
        for k, d in stats.items():
            cur = _STATS.setdefault(k, {})
            for o, n in d.items():
                cur[o] = cur.get(o, 0) + n


def routing_state():
    """What the wrappers and lowerings read at each call to choose a
    kernel or its plain version: the flag, the knobs, the plain-reference
    switch, the CPU hook and the registered kernels. A captured graph
    replays the choices of its capture, so the engine captures again
    when this changes."""
    from ..core.flags import FLAGS
    from ..tuning import knobs
    return (bool(FLAGS.use_custom_kernels),
            tuple(knobs.value(k) for k in knobs.names()),
            plain_forced(), _ROUTE_ON_CPU,
            tuple((n, id(k)) for n, k in _KERNELS.items()))


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
