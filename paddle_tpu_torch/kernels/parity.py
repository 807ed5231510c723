"""Numerics-parity harness: each kernel against the lowered op it stands
in for (counterpart of paddle_tpu/kernels/parity.py, in part).

A case runs its baseline through the port's own op lowering
(core.registry.OPS) with the registry flag off, so the baseline is the
arithmetic users get with kernels off (plain_reference() besides, so
that no wrapper reached another way launches); then it runs the
kernel's entry point, which launches the kernel for CUDA tensors and
runs its plain version for CPU tensors. Both run on the device the case
is given.

Tolerances are the JAX package's: ulp bounds for value-preserving
kernels (Adam and SGD: 4 ulp), relative error in the norm for
value-approximating ones (quantized matmul int8 5e-2 and bf16 1e-2 on unit-scale data; the
tuned GEMM variants 1e-4, float32 reassociation only).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List

import numpy as np
import torch

__all__ = ["Case", "cases", "run_case", "max_ulp", "rel_err"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def max_ulp(ref, got) -> float:
    """Largest elementwise |got - ref| in units of ref's last place."""
    ref, got = _np(ref), _np(got)
    dt = ref.dtype if ref.dtype.kind == "f" else np.dtype(np.float32)
    if ref.size == 0:
        return 0.0
    spacing = np.spacing(
        np.maximum(np.abs(ref), np.finfo(dt).tiny).astype(dt)
    ).astype(np.float64)
    diff = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    return float(np.max(diff / spacing))


def rel_err(ref, got) -> float:
    """||got - ref|| / ||ref||, in float64."""
    ref = _np(ref).astype(np.float64)
    got = _np(got).astype(np.float64)
    return float(np.linalg.norm((got - ref).ravel())
                 / max(np.linalg.norm(ref.ravel()), 1e-30))


@contextlib.contextmanager
def _kernels_off():
    from ..core.flags import FLAGS, set_flags
    from . import registry
    prev = bool(FLAGS.use_custom_kernels)
    set_flags({"FLAGS_use_custom_kernels": False})
    try:
        with registry.plain_reference():
            yield
    finally:
        set_flags({"FLAGS_use_custom_kernels": prev})


def _run_lowered(op_type: str, inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]], attrs: Dict[str, Any],
                 env: Dict[str, torch.Tensor], device):
    """Run one op through the port's lowering with the kernels off;
    returns env with the outputs added."""
    from ..core.registry import OPS, ExecContext, _SlotView
    op = _SlotView(op_type, inputs, outputs, attrs)
    with _kernels_off(), torch.no_grad():
        OPS.get(op_type).lowering(ExecContext(op, env, device))
    return env


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

class Case:
    """One (kernel, configuration) parity check. `runner(device)`
    returns {"metric", "tol", "value"}."""

    __slots__ = ("kernel", "label", "runner")

    def __init__(self, kernel: str, label: str, runner: Callable):
        self.kernel = kernel
        self.label = label
        self.runner = runner

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Case({self.label})"


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _adam_case(shape):
    def run(device):
        r = np.random.default_rng(7)
        p = r.standard_normal(shape, dtype=np.float32)
        g = r.standard_normal(shape, dtype=np.float32)
        m = 0.1 * r.standard_normal(shape, dtype=np.float32)
        v = np.abs(0.01 * r.standard_normal(shape, dtype=np.float32))
        lr = np.float32(1e-3)
        b1p, b2p = np.float32(0.9 ** 3), np.float32(0.999 ** 3)
        env = {"p": _t(p, device), "g": _t(g, device), "m": _t(m, device),
               "v": _t(v, device), "lr": _t(np.array([lr]), device),
               "b1p": _t(np.array([b1p]), device),
               "b2p": _t(np.array([b2p]), device)}
        _run_lowered(
            "adam",
            {"Param": ["p"], "Grad": ["g"], "Moment1": ["m"],
             "Moment2": ["v"], "LearningRate": ["lr"],
             "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]},
            {"ParamOut": ["po"], "Moment1Out": ["mo"],
             "Moment2Out": ["vo"], "Beta1PowOut": [], "Beta2PowOut": []},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, env, device)
        from .fused_optimizer import fused_adam
        lr_t = (env["lr"] * torch.sqrt(1 - env["b2p"])
                / (1 - env["b1p"])).reshape(1)
        # fresh copies: the kernel updates p, m, v in place
        po, mo, vo = fused_adam(_t(p, device), env["g"], _t(m, device),
                                _t(v, device), lr_t, beta1=0.9,
                                beta2=0.999, epsilon=1e-8)
        return {"metric": "ulp", "tol": 4.0,
                "value": max(max_ulp(env["po"], po),
                             max_ulp(env["mo"], mo),
                             max_ulp(env["vo"], vo))}
    return Case("fused_adam", f"fused_adam/f32/{shape}", run)


def _sgd_case(shape):
    def run(device):
        r = np.random.default_rng(11)
        p = r.standard_normal(shape, dtype=np.float32)
        g = r.standard_normal(shape, dtype=np.float32)
        env = {"p": _t(p, device), "g": _t(g, device),
               "lr": _t(np.array([0.05], np.float32), device)}
        _run_lowered("sgd",
                     {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]},
                     {"ParamOut": ["po"]}, {}, env, device)
        from .fused_optimizer import fused_sgd
        # a fresh copy: the kernel updates p in place
        po = fused_sgd(_t(p, device), env["g"], env["lr"])
        return {"metric": "ulp", "tol": 4.0,
                "value": max_ulp(env["po"], po)}
    return Case("fused_sgd", f"fused_sgd/f32/{shape}", run)


def _qmm_case(mode, tol):
    def run(device):
        r = np.random.default_rng(13)
        x = r.standard_normal((256, 384), dtype=np.float32)
        y = r.standard_normal((384, 128), dtype=np.float32)
        env = {"x": _t(x, device), "y": _t(y, device)}
        _run_lowered("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
                     {"x_num_col_dims": 1, "y_num_col_dims": 1}, env,
                     device)
        from .quantized_matmul import quantized_matmul
        got = quantized_matmul(env["x"], env["y"], mode=mode)
        return {"metric": "rel", "tol": tol,
                "value": rel_err(env["out"], got)}
    return Case(f"quantized_matmul_{mode}",
                f"quantized_matmul/{mode}/256x384x128", run)


def cases() -> List[Case]:
    """Every parity case: Adam, SGD, quantized_matmul int8 and bf16, and
    the tuned GEMM variants of the JAX package's default problem
    (256^3)."""
    from ..tuning import variants
    out = [_adam_case((4096,)), _adam_case((513, 7)), _sgd_case((2048,)),
           _sgd_case((129, 5)), _qmm_case("int8", 5e-2),
           _qmm_case("bf16", 1e-2)]
    return out + [case for _, case in variants.variant_cases()]


def run_case(case: Case, device=None) -> Dict[str, Any]:
    """Run one case on `device`, or on the default place's device
    (CUDAPlace(0), which raises where torch sees no card) when None."""
    if device is None:
        from ..core.place import default_place
        device = default_place().torch_device()
    res = case.runner(torch.device(device))
    res.update(kernel=case.kernel, label=case.label,
               passed=bool(res["value"] <= res["tol"]))
    return res

