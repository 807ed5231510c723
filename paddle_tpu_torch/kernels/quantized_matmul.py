"""Quantized matrix product (int8 / bf16): the wrapper of the CUDA kernel,
its plain PyTorch version and its registration for ``mul``/``matmul``.

Counterpart of paddle_tpu/kernels/quantized_matmul.py (_qmm_block via
quantized_matmul). The kernel is paddle_tpu_torch/csrc/quantized_matmul.cu
(wgmma and TMA: one pre-pass launch for the operands, then the GEMM).
C = x @ y for x [M, K], y [K, N] (float32 or bf16, M, N, K multiples of
128), float32 out unless `out_dtype` is given:

* "int8": one scale per 128x128 tile of x and of y,
  s = max(max|tile|, 1e-30) / 127; tiles rounded to
  clamp(round(v / s), -127, 127) (half to even); each 128-deep K tile's
  exact integer product is scaled by sx * sy and added to a float32
  accumulator in K order. The kernel equals the plain version bit for
  bit.
* "bf16": x and y rounded to bf16, products summed in float32.

Opt-in, since it changes numerics: the registry selects it for a mul or
matmul only while ``PT_KERNEL_QUANT_MATMUL=int8|bf16`` is set, for 2-D
float32/bf16 operands whose dims are multiples of 128 (`_qmm_eligible`,
as in the JAX package). A CUDA tensor launches the kernel (launches
counted as quantized_matmul_int8 / quantized_matmul_bf16); a CPU tensor,
or a CUDA one under kernels.registry.plain_reference(), takes the plain
version. The kernel has no backward: its gradient raises
(registry.forward_only).

Tolerance policy (kernels/parity.py): relative error against the
float32 mul, 5e-2 for int8 and 1e-2 for bf16 on unit-scale data.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

_TILE = 128
_KERNELS = {"int8": "quantized_matmul_int8", "bf16": "quantized_matmul_bf16"}
_MODE_CODES = {"int8": 0, "bf16": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["quantized_matmul", "quantized_matmul_plain", "quant_mode"]


def quant_mode() -> str:
    """The requested mode, "int8" or "bf16" ("" = kernel off), from the
    kernel_quant_matmul knob (PT_KERNEL_QUANT_MATMUL)."""
    from ..tuning import knobs
    mode = str(knobs.value("kernel_quant_matmul") or "").strip().lower()
    return mode if mode in _KERNELS else ""


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _tiles(v):
    """[R, C] -> [R/128, 128, C/128, 128] view."""
    R, C = v.shape
    return v.reshape(R // _TILE, _TILE, C // _TILE, _TILE)


def tile_scales(v):
    """float32 [R/128, C/128]: max(max|tile|, 1e-30) / 127 per tile of a
    float32 [R, C]. Both divisions are tensor by tensor (torch turns a
    division by a Python scalar into a multiplication by its reciprocal
    on CUDA, which rounds differently)."""
    amax = _tiles(v).abs().amax(dim=(1, 3))
    return torch.maximum(amax, torch.full_like(amax, 1e-30)) / \
        torch.full_like(amax, 127.0)


def quantize_int8(v, scales):
    """float32 [R, C] of integers in [-127, 127]: each tile of v divided by
    its scale and rounded half to even."""
    q = torch.round(_tiles(v) / scales[:, None, :, None]).clamp(-127, 127)
    return q.reshape(v.shape)


def quantized_matmul_plain(x, y, mode):
    """The kernel's function in plain PyTorch, float32 out."""
    x, y = x.float(), y.float()
    if mode == "bf16":
        return x.to(torch.bfloat16).float() @ y.to(torch.bfloat16).float()
    if mode != "int8":
        raise ValueError(f"quantized_matmul: unknown mode {mode!r}")
    M, K = x.shape
    N = y.shape[1]
    sx, sy = tile_scales(x), tile_scales(y)
    qx, qy = quantize_int8(x, sx), quantize_int8(y, sy)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for kt in range(K // _TILE):
        ks = slice(kt * _TILE, (kt + 1) * _TILE)
        # integers below 2**24 at every partial sum: exact in float32
        part = _tiles(qx[:, ks] @ qy[ks, :])
        acc = acc + (part * (sx[:, kt, None] * sy[None, kt, :])
                     [:, None, :, None]).reshape(M, N)
    return acc


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _check_shapes(x, y):
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} are not a 2-D product")
    if any(d % _TILE for d in (*x.shape, y.shape[1])):
        raise ValueError(f"quantized_matmul: dims of x {tuple(x.shape)} and "
                         f"y {tuple(y.shape)} must be multiples of {_TILE}")


def _run(x, y, mode):
    if x.device.type == "cuda" and not registry.plain_forced():
        return _launch(x, y, mode)
    if x.device.type in ("cpu", "meta", "cuda"):
        return quantized_matmul_plain(x, y, mode)
    raise ValueError(f"quantized_matmul: unsupported device {x.device}")


def quantized_matmul(x, y, *, mode=None, out_dtype=None):
    """C = x @ y with per-tile quantization (see the module docstring).
    mode: "int8" or "bf16" (default: the PT_KERNEL_QUANT_MATMUL mode,
    else bf16). Returns float32 unless `out_dtype` is given."""
    mode = mode or quant_mode() or "bf16"
    if mode not in _KERNELS:
        raise ValueError(f"quantized_matmul: unknown mode {mode!r}")
    _check_shapes(x, y)
    out = registry.forward_only(_KERNELS[mode],
                                lambda a, b: _run(a, b, mode), x, y)
    if out_dtype is not None and out.dtype != out_dtype:
        out = out.to(out_dtype)
    return out


def _check(x, y):
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"quantized_matmul: {name} is on {t.device}, "
                             f"x on {x.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"quantized_matmul kernel takes float32 or "
                            f"bfloat16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"quantized_matmul kernel: {name} must be "
                             f"contiguous")


def _bind(lib):
    fn = lib.pt_quantized_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = i
    return fn


def _launch(x, y, mode):
    _check(x, y)
    M, K = x.shape
    N = y.shape[1]
    dev = x.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = empty((M, N), torch.float32)
    sa = sb = None
    if mode == "int8":
        wa, wb = empty((M, K), torch.int8), empty((N, K), torch.int8)
        sa = empty((M // _TILE, K // _TILE), torch.float32)
        sb = empty((K // _TILE, N // _TILE), torch.float32)
    else:
        # an x aligned to 16 bytes is read as it is (float32 is rounded to
        # bf16 inside the GEMM); otherwise the pre-pass rounds it into wa
        wa = None if x.data_ptr() % 16 == 0 \
            else empty((M, K), torch.bfloat16)
        wb = empty((N, K), torch.bfloat16)
    name = _KERNELS[mode]
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _bind(registry.library(name))
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), _DTYPES[x.dtype], y.data_ptr(),
                 _DTYPES[y.dtype], M, N, K, _MODE_CODES[mode], ptr(wa),
                 ptr(wb), ptr(sa), ptr(sb), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    registry.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def _qmm_eligible(sig: registry.Signature) -> bool:
    if not quant_mode():
        return False
    if len(sig.shapes) != 2:
        return False
    (a, b) = sig.shapes
    if len(a) != 2 or len(b) != 2 or a[1] != b[0]:
        return False
    if any(d % _TILE for d in (a[0], a[1], b[1])):
        return False
    return all(dt in ("float32", "bfloat16") for dt in sig.dtypes)


registry.register_kernel(
    "quantized_matmul", op_types=("mul", "matmul"),
    eligible=_qmm_eligible, run=quantized_matmul,
    doc="per-tile int8/bf16 GEMM for inference-shaped programs; opt-in "
        "via PT_KERNEL_QUANT_MATMUL=int8|bf16, 2-D operands with "
        "128-multiple dims")
