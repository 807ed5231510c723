"""GEMM variant search: generate and verify over tile shapes and fused
epilogues, ranked by time measured on the card (counterpart of
paddle_tpu/tuning/variants.py).

A variant is a tile shape (bm, bn, bk) crossed with an epilogue: none,
layer_norm (the row normalized with eps 1e-5, times gamma, plus beta;
needs bn == N) or dropout_residual (acc * mask / 0.9 + residual). The
JAX package's space is TPU tile shapes; the port's is the tile shapes
its two CUDA sources instantiate, and a tile names its design:

* csrc/tuned_matmul.cu, float32 on the CUDA cores: GEMM tiles (bk 8 or
  16) for none and dropout_residual, row tiles (bm 16 or 32, bn 256 or
  512, the whole row of C) for layer_norm;
* csrc/tuned_matmul_sm90.cu, 3xTF32 on the tensor cores (wgmma + TMA,
  B^T split into tf32 hi and lo by a pre-pass launch): 128x128x32,
  128x256x32 and 128x256x16 for none and dropout_residual, 64x256x32
  and 64x512x16 for layer_norm.

The search times both designs in the same run. The legality rule is the
JAX package's: the tile divides the problem, and layer_norm needs
bn == N.

``search_variants`` admits only variants whose parity case passes
against the composed PyTorch baseline (kernels/parity.py), then ranks
the admitted ones by time on the card: CUDA events around a run of
back-to-back calls (queued behind a sleep on the card), per call, the
median of several runs (a single call between two events measures the
host's launch more than the card). It times only on the card: on the
CPU it verifies parity (the wrapper runs its plain version there),
reports no time, ranks nothing, and says so with ``"timed": False``. ``register_winner`` makes the
``none`` winner the ``tuned_matmul`` kernel of the registry for float32
mul/matmul; the layer_norm and dropout_residual winners have no op to
route (the JAX package routes only ``none`` too), so the search is their
path.

``tuned_matmul`` launches the kernel for CUDA tensors (launch counts by
epilogue and design: tuned_matmul, tuned_matmul_ln, tuned_matmul_dr on
the CUDA cores, tuned_matmul_sm90, tuned_matmul_ln_sm90,
tuned_matmul_dr_sm90 on the tensor cores; ``Variant.kernel`` names a
variant's) and runs the
plain version (``tuned_matmul_plain``) for CPU tensors and under
kernels.registry.plain_reference(). It has no backward: its gradient
raises (registry.forward_only).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.place import default_place

__all__ = ["Variant", "enumerate_variants", "variant_cases",
           "verify_variant", "search_variants", "tuned_matmul",
           "tuned_matmul_plain", "register_winner"]

_LN_EPS = 1e-5
_KEEP = 0.9          # dropout keep probability of the fused epilogue
_REL_TOL = 1e-4      # float32 reassociation only (blocked-K sums)
_RUNS = 5            # timed runs of back-to-back calls a variant
# the card's sleep ahead of a timed run, per call queued behind it:
# ~0.5 ms at the H100's clocks, several times what the host takes to
# queue one call
_SLEEP_CYCLES = 1_000_000

_EPILOGUES = ("none", "layer_norm", "dropout_residual")
_EPI_CODES = {"none": 0, "layer_norm": 1, "dropout_residual": 2}
# launch counters by epilogue (the CUDA-core design; "_sm90" appended for
# the tensor-core one)
_KERNELS = {"none": "tuned_matmul", "layer_norm": "tuned_matmul_ln",
            "dropout_residual": "tuned_matmul_dr"}
# the tile shapes csrc/tuned_matmul.cu instantiates, by epilogue
_GEMM_BLOCKS = ((64, 64, 16), (128, 64, 16), (128, 128, 8))
_ROW_BLOCKS = ((16, 256, 16), (32, 256, 8), (16, 512, 8), (32, 512, 8))
# and csrc/tuned_matmul_sm90.cu (bk 32: one 128-byte row of float32; 16
# where a 32-deep stage of B^T hi and lo would leave room for one)
_SM90_GEMM_BLOCKS = ((128, 128, 32), (128, 256, 32), (128, 256, 16))
_SM90_BLOCKS = {"none": _SM90_GEMM_BLOCKS,
                "layer_norm": ((64, 256, 32), (64, 512, 16)),
                "dropout_residual": _SM90_GEMM_BLOCKS}
_BLOCKS = {"none": _GEMM_BLOCKS + _SM90_BLOCKS["none"],
           "layer_norm": _ROW_BLOCKS + _SM90_BLOCKS["layer_norm"],
           "dropout_residual": _GEMM_BLOCKS
           + _SM90_BLOCKS["dropout_residual"]}


class Variant:
    """One (tile shape, epilogue) point of the search space."""

    __slots__ = ("bm", "bn", "bk", "epilogue")

    def __init__(self, bm: int, bn: int, bk: int, epilogue: str):
        self.bm, self.bn, self.bk = bm, bn, bk
        self.epilogue = epilogue

    @property
    def label(self) -> str:
        return (f"tuned_matmul/{self.epilogue}/"
                f"{self.bm}x{self.bn}x{self.bk}")

    @property
    def sm90(self) -> bool:
        """A tile of the tensor-core design (tuned_matmul_sm90.cu)."""
        return (self.bm, self.bn, self.bk) in _SM90_BLOCKS.get(
            self.epilogue, ())

    @property
    def kernel(self) -> str:
        """The launch counter (and registry.SOURCES name) of this
        variant's kernel."""
        return _KERNELS[self.epilogue] + ("_sm90" if self.sm90 else "")

    def as_dict(self) -> Dict[str, Any]:
        return {"bm": self.bm, "bn": self.bn, "bk": self.bk,
                "epilogue": self.epilogue}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Variant({self.label})"


# ---------------------------------------------------------------------------
# the kernel's entry point and its plain version
# ---------------------------------------------------------------------------

def tuned_matmul_plain(x, y, *, variant: Variant, gamma=None, beta=None,
                       mask=None, residual=None):
    """epilogue(x @ y) in plain PyTorch, float32 (the composed baseline;
    the tile shape does not change the function)."""
    out = x @ y
    if variant.epilogue == "layer_norm":
        mu = out.mean(dim=1, keepdim=True)
        var = ((out - mu) * (out - mu)).mean(dim=1, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + _LN_EPS)
        out = out * gamma[None, :] + beta[None, :]
    elif variant.epilogue == "dropout_residual":
        out = out * mask * (1.0 / _KEEP) + residual
    return out


def _operands(variant, gamma, beta, mask, residual):
    if variant.epilogue == "layer_norm":
        return gamma, beta
    if variant.epilogue == "dropout_residual":
        return mask, residual
    return None, None


def tuned_matmul(x, y, *, variant: Variant, gamma=None, beta=None,
                 mask=None, residual=None):
    """C = epilogue(x @ y) under `variant`'s tiles. x [M, K], y [K, N]
    float32, dims divisible by the variant's tile; layer_norm needs
    bn == N and gamma, beta [N]; dropout_residual needs mask, residual
    [M, N]."""
    if variant.epilogue not in _EPI_CODES:
        raise ValueError(f"unknown epilogue {variant.epilogue!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"tuned_matmul: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} are not a 2-D product")
    (M, K), N = x.shape, y.shape[1]
    if M % variant.bm or K % variant.bk or N % variant.bn:
        raise ValueError(f"tuned_matmul: {variant.label} does not divide "
                         f"M={M} N={N} K={K}")
    if variant.epilogue == "layer_norm" and variant.bn != N:
        raise ValueError(f"tuned_matmul: the layer_norm epilogue needs "
                         f"full rows (bn={variant.bn}, N={N})")
    p0, p1 = _operands(variant, gamma, beta, mask, residual)
    if variant.epilogue != "none" and (p0 is None or p1 is None):
        raise ValueError(f"tuned_matmul: the {variant.epilogue} epilogue "
                         f"needs its two operands")

    def run(a, b, q0, q1):
        from ..kernels import registry as kreg
        if a.device.type == "cuda" and not kreg.plain_forced():
            return _launch(a, b, variant, q0, q1)
        if a.device.type in ("cpu", "meta", "cuda"):
            return tuned_matmul_plain(
                a, b, variant=variant, gamma=gamma, beta=beta, mask=mask,
                residual=residual)
        raise ValueError(f"tuned_matmul: unsupported device {a.device}")

    from ..kernels import registry as kreg
    return kreg.forward_only(variant.kernel, run, x, y, p0, p1)


def _bind(lib, symbol):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if symbol == "pt_tuned_matmul":
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p]
        elif symbol == "pt_tuned_matmul_sm90":   # and the workspace bt
            fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p, p]
        elif symbol == "pt_tuned_matmul_sm90_round_probe":
            fn.argtypes = [p, p]
        else:
            fn.argtypes = [ctypes.POINTER(ctypes.c_int), i]
        fn.restype = i
    return fn


def instantiated_variants() -> List[tuple]:
    """(bm, bn, bk, epilogue) of every variant the built libraries hold,
    the CUDA-core design's, then the tensor-core one's (builds them at
    first use)."""
    from ..kernels import registry as kreg
    names = {c: e for e, c in _EPI_CODES.items()}
    out = []
    for name, symbol in (("tuned_matmul", "pt_tuned_matmul_variants"),
                         ("tuned_matmul_sm90",
                          "pt_tuned_matmul_sm90_variants")):
        fn = _bind(kreg.library(name), symbol)
        n = fn(None, 0)
        buf = (ctypes.c_int * (4 * n))()
        fn(buf, n)
        out += [(buf[4 * i], buf[4 * i + 1], buf[4 * i + 2],
                 names[buf[4 * i + 3]]) for i in range(n)]
    return out


def round_probe(device=None) -> torch.Tensor:
    """[64, 64] float32 from one tf32 wgmma onto an accumulator of +-1
    that adds 0.625 of its last place (csrc/tuned_matmul_sm90.cu
    round_probe_kernel): +-(1 + 2^-23) everywhere if the tensor cores
    round their float32 sums to nearest, +-1 if toward zero."""
    from ..kernels import registry as kreg
    dev = _device(device)
    if dev.type != "cuda":
        raise ValueError("round_probe runs on a CUDA device")
    out = torch.empty((64, 64), dtype=torch.float32, device=dev)
    fn = _bind(kreg.library("tuned_matmul_sm90"),
               "pt_tuned_matmul_sm90_round_probe")
    with torch.cuda.device(dev):
        err = fn(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"round probe failed with CUDA error {err}")
    return out


def _launch(x, y, variant, p0, p1):
    from ..kernels import registry as kreg
    name = variant.kernel
    for t in (x, y, p0, p1):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: operands must be float32 on "
                            f"{x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    (M, K), N = x.shape, y.shape[1]
    if M // variant.bm > 65535:
        raise ValueError(f"{name}: M={M} is too large for bm={variant.bm}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = [x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
            variant.bm, variant.bn, variant.bk,
            _EPI_CODES[variant.epilogue], ptr(p0), ptr(p1)]
    if variant.sm90:
        # the pre-pass writes B^T split into tf32 hi (rows 0..N-1) and lo
        bt = torch.empty((2 * N, K), dtype=torch.float32, device=x.device)
        fn = _bind(kreg.library(name), "pt_tuned_matmul_sm90")
        args.append(bt.data_ptr())
    else:
        fn = _bind(kreg.library(name), "pt_tuned_matmul")
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} ({variant.label}) launch failed with "
                           f"CUDA error {err}")
    kreg.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# enumerate -> verify -> rank
# ---------------------------------------------------------------------------

def enumerate_variants(M: int = 256, N: int = 256, K: int = 256
                       ) -> List[Variant]:
    """Legal (tile, epilogue) points for an M x N x K problem."""
    out = []
    for ep in _EPILOGUES:
        for bm, bn, bk in _BLOCKS[ep]:
            if M % bm or N % bn or K % bk:
                continue
            if ep == "layer_norm" and bn != N:
                continue
            out.append(Variant(bm, bn, bk, ep))
    return out


def _device(device) -> torch.device:
    """`device`, or the default place's (CUDAPlace(0), which raises where
    torch sees no card): the search never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    return default_place().torch_device()


def _problem(M, N, K, device, seed=23):
    """The JAX package's problem (same numpy draws), as float32 tensors
    on `device`."""
    r = np.random.default_rng(seed)
    data = {
        "x": r.standard_normal((M, K), dtype=np.float32),
        "y": r.standard_normal((K, N), dtype=np.float32),
        "gamma": 1.0 + 0.1 * r.standard_normal(N, dtype=np.float32),
        "beta": 0.1 * r.standard_normal(N, dtype=np.float32),
        "mask": (r.random((M, N)) < _KEEP).astype(np.float32),
        "residual": r.standard_normal((M, N), dtype=np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device) for k, v in data.items()}


def _kwargs(v: Variant, d):
    if v.epilogue == "layer_norm":
        return {"gamma": d["gamma"], "beta": d["beta"]}
    if v.epilogue == "dropout_residual":
        return {"mask": d["mask"], "residual": d["residual"]}
    return {}


def _run_variant(v: Variant, d):
    return tuned_matmul(d["x"], d["y"], variant=v, **_kwargs(v, d))


def variant_cases(M: int = 256, N: int = 256, K: int = 256):
    """The enumerated space as kernels/parity.py Case objects: each
    variant against the composed baseline (the plain version, run under
    plain_reference() so that it is plain on the card too)."""
    from ..kernels import registry as kreg
    from ..kernels.parity import Case, rel_err

    def make(v):
        def run(device):
            d = _problem(M, N, K, device)
            with kreg.plain_reference():
                ref = _run_variant(v, d)
            got = _run_variant(v, d)
            return {"metric": "rel", "tol": _REL_TOL,
                    "value": rel_err(ref, got)}
        return Case(v.kernel, v.label, run)

    return [(v, make(v)) for v in enumerate_variants(M, N, K)]


def verify_variant(v: Variant, M=256, N=256, K=256, device=None
                   ) -> Dict[str, Any]:
    from ..kernels.parity import run_case
    for vv, case in variant_cases(M, N, K):
        if vv.label == v.label:
            return run_case(case, _device(device))
    raise KeyError(v.label)


def _time_ms(fn, iters, runs=_RUNS):
    """ms a call on the card: CUDA events around `iters` calls queued
    behind a sleep on the card (the host queues them meanwhile, so the
    card runs them back to back however long the host takes a call),
    divided by `iters`; the median of `runs` such runs. Returns (that,
    the median of `iters` single calls between two events, which is
    what a lone call costs on the host's clock, launches included)."""
    fn()                                   # warm-up (and build)
    torch.cuda.synchronize()

    def events(n, queued):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(_SLEEP_CYCLES * n)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    n = max(1, iters)
    runs_ms = sorted(events(n, True) for _ in range(max(1, runs)))
    single = sorted(events(1, False) for _ in range(n))
    return runs_ms[len(runs_ms) // 2], single[len(single) // 2]


def search_variants(M: int = 256, N: int = 256, K: int = 256,
                    iters: int = 3, device=None) -> Dict[str, Any]:
    """enumerate -> parity-admit -> rank by ms a call on the card.

    Returns {"timed", "device", "problem", "considered", "admitted":
    [{bm, bn, bk, epilogue, rel_err, ms, single_ms}], "winners":
    {epilogue: row}}: "ms" is the median over runs of `iters`
    back-to-back calls (the ranking), "single_ms" the median of single
    calls. On the CPU, "timed" is False, both times are None and
    "winners" is empty: parity is verified, nothing is ranked."""
    from ..kernels.parity import run_case
    dev = _device(device)
    timed = dev.type == "cuda"
    considered = 0
    admitted: List[Dict[str, Any]] = []
    for v, case in variant_cases(M, N, K):
        considered += 1
        res = run_case(case, dev)
        if not res["passed"]:
            continue
        ms = single = None
        if timed:
            d = _problem(M, N, K, dev)
            ms, single = _time_ms(lambda v=v, d=d: _run_variant(v, d), iters)
        admitted.append({**v.as_dict(), "rel_err": res["value"], "ms": ms,
                         "single_ms": single})
    winners: Dict[str, Any] = {}
    if timed:
        for row in sorted(admitted, key=lambda r: (r["ms"], r["bm"],
                                                   r["bn"], r["bk"])):
            winners.setdefault(row["epilogue"], row)
    return {"timed": timed,
            "device": (torch.cuda.get_device_name(dev) if timed
                       else "cpu"),
            "problem": [M, N, K],
            "considered": considered,
            "admitted": admitted,
            "winners": winners}


def register_winner(winners: Dict[str, Any]) -> Optional[str]:
    """Make the ``none`` winner the registry's tuned_matmul kernel for
    float32 mul/matmul. Returns the registered name, or None when there
    is no ``none`` winner."""
    row = (winners or {}).get("none")
    if not row:
        return None
    from ..kernels import registry as kreg
    v = Variant(int(row["bm"]), int(row["bn"]), int(row["bk"]), "none")

    def run(x, y, **_kw):
        return tuned_matmul(x, y, variant=v)

    def eligible(sig: "kreg.Signature") -> bool:
        if len(sig.shapes) != 2:
            return False
        a, b = sig.shapes
        if len(a) != 2 or len(b) != 2 or a[1] != b[0]:
            return False
        if a[0] % v.bm or a[1] % v.bk or b[1] % v.bn:
            return False
        if sig.numel < kreg.min_numel():
            return False
        return all(dt == "float32" for dt in sig.dtypes)

    kreg.register_kernel(
        "tuned_matmul", op_types=("mul", "matmul"), eligible=eligible,
        run=run, doc=f"autotuned float32 GEMM, tiles {v.bm}x{v.bn}x{v.bk} "
                     f"(winner of the variant search)")
    return "tuned_matmul"
