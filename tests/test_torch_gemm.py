"""The port's kernel registry and GEMM kernels against the JAX package.

* Registry gating (kernels/registry.py): opt-in, deny list, master flag,
  shape gates, first eligible wins, no routing on the CPU without the
  test hook, and the same decision as the JAX registry for the same
  operands and knobs.
* quantized_matmul (int8, bf16): the port's plain version against the
  JAX Pallas kernel in interpret mode, on numpy inputs from a seed.
* mul and matmul through the port's lowering with the hook armed,
  against the JAX lowerings with their interpret hook armed.
* tuned_matmul, each epilogue, against the JAX tuned_matmul in
  interpret mode; the variant space, the search and register_winner.
* A tiny Transformer scored by both Executors in int8 and bf16 mode.
* A gradient through a forward-only kernel raises, in both packages.

Tolerances, relative in the norm unless said otherwise:
* int8 GEMM 1e-6. Both sides compute the same scales and quantized
  values (held equal, bit for bit) and sum exact integer tile products;
  only the float32 accumulation may differ in its last bit.
* bf16 GEMM 1e-5: products of bf16 values are exact in float32, the sums
  run in another order.
* tuned GEMM 1e-4 (the JAX package's _REL_TOL): float32 reassociation.
* Tiny Transformer logits: int8 1e-6 (measured 6e-8), bf16 2e-3
  (measured 2.7e-4). In bf16 mode each GEMM's float32 result differs in
  its last bits between XLA and torch, and the next GEMM rounds its
  input to bf16 again: a value near a bf16 rounding boundary moves by
  half a bf16 step (2e-3 relative), and such flips compound through the
  layers. int8 rounds to 1/127 of a tile's range, whose boundaries a
  last-bit difference almost never crosses.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.kernels import registry as jkreg
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.tuning import variants as jvariants

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import parity as pparity
from paddle_tpu_torch.kernels import quantized_matmul as pqm
from paddle_tpu_torch.kernels import registry as pkreg
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.tuning import knobs as pknobs
from paddle_tpu_torch.tuning import variants as pvariants
from torch_threads import one_torch_thread  # noqa: F401

jqm = importlib.import_module("paddle_tpu.kernels.quantized_matmul")

INT8_RTOL = 1e-6
BF16_RTOL = 1e-5
TUNED_RTOL = 1e-4
GEMM_RTOL = 1e-5     # a kernel on the card against its plain version
TF_LOGITS_RTOL = {"int8": 1e-6, "bf16": 2e-3}
TF_COST_ATOL = {"int8": 1e-5, "bf16": 1e-4}


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(autouse=True)
def _clean_registry():
    """Every test starts and ends with the flag on, no tuned winner and
    empty dispatch counts in both packages."""
    yield
    set_flags({"FLAGS_use_custom_kernels": True})
    pkreg.unregister_kernel("tuned_matmul")
    pkreg.unregister_kernel("first")
    pkreg.unregister_kernel("second")
    pkreg.reset_stats()
    jkreg._KERNELS.pop("tuned_matmul", None)
    for lst in jkreg._BY_OP.values():
        lst[:] = [k for k in lst if k.name != "tuned_matmul"]
    jkreg.reset_stats()


@pytest.fixture
def route(monkeypatch):
    """Arm both packages' CPU hooks and drop the size floor, so both
    registries route on the CPU."""
    monkeypatch.setattr(pkreg, "_ROUTE_ON_CPU", True)
    monkeypatch.setattr(jkreg, "_INTERPRET", True)
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    monkeypatch.delenv("PT_KERNEL_QUANT_MATMUL", raising=False)
    monkeypatch.delenv("PT_KERNEL_DENY", raising=False)


def _sig(op, *shapes, dtype="float32", device="cpu"):
    return pkreg.Signature(op, (dtype,) * len(shapes),
                           tuple(tuple(s) for s in shapes), device)


def _np_inputs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s, dtype=np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# registry gating
# ---------------------------------------------------------------------------

def test_knobs_read_the_environment(monkeypatch):
    monkeypatch.delenv("PT_KERNEL_MIN_NUMEL", raising=False)
    assert pknobs.value("kernel_min_numel") == 65536
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "128")
    assert pkreg.min_numel() == 128
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "not a number")
    assert pkreg.min_numel() == 65536
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", " INT8 ")
    assert pqm.quant_mode() == "int8"
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "fp8")
    assert pqm.quant_mode() == ""
    with pytest.raises(KeyError, match="unknown knob"):
        pknobs.value("kernel_nothing")


def test_flags_set_get_and_reject_unknown():
    assert get_flags("use_custom_kernels") == {
        "FLAGS_use_custom_kernels": True}
    set_flags({"FLAGS_use_custom_kernels": "0"})
    assert get_flags(["FLAGS_use_custom_kernels"]) == {
        "FLAGS_use_custom_kernels": False}
    with pytest.raises(ValueError, match="unknown flag"):
        set_flags({"FLAGS_no_such_flag": 1})


def test_quant_matmul_requires_opt_in(route):
    assert pkreg.select("mul", _sig("mul", (128, 256), (256, 128))) is None
    assert pkreg.dispatch_stats()["per_kernel"] == {
        "quantized_matmul": {"lowered": 1}}


@pytest.mark.parametrize("shapes,dtype,eligible", [
    (((128, 256), (256, 128)), "float32", True),
    (((256, 384), (384, 128)), "bfloat16", True),
    (((100, 256), (256, 128)), "float32", False),     # M not x128
    (((128, 200), (200, 128)), "float32", False),     # K not x128
    (((128, 256), (256, 96)), "float32", False),      # N not x128
    (((128, 256), (128, 128)), "float32", False),     # K mismatch
    (((2, 128, 256), (256, 128)), "float32", False),  # not 2-D
    (((128, 256), (256, 128)), "float16", False),
])
def test_quant_matmul_shape_and_dtype_gates(route, monkeypatch, shapes,
                                            dtype, eligible):
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "int8")
    sel = pkreg.select("mul", _sig("mul", *shapes, dtype=dtype))
    assert (sel is not None and sel.name == "quantized_matmul") == eligible


def test_deny_list_and_flag_off(route, monkeypatch):
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "bf16")
    sig = _sig("matmul", (128, 128), (128, 128))
    assert pkreg.select("matmul", sig).name == "quantized_matmul"
    monkeypatch.setenv("PT_KERNEL_DENY", "other, quantized_matmul")
    assert not pkreg.allowed("quantized_matmul")
    assert pkreg.select("matmul", sig) is None
    monkeypatch.delenv("PT_KERNEL_DENY")
    set_flags({"FLAGS_use_custom_kernels": False})
    assert not pkreg.routable("matmul", "cpu")
    assert not pkreg.allowed("quantized_matmul")
    assert pkreg.select("matmul", sig) is None
    assert pkreg.dispatch_stats()["per_kernel"]["quantized_matmul"] == {
        "custom": 1, "denied": 2}


def test_no_routing_on_cpu_without_the_hook(monkeypatch):
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "int8")
    assert not pkreg._ROUTE_ON_CPU
    sig = _sig("mul", (128, 128), (128, 128))
    assert not pkreg.routable("mul", torch.device("cpu"))
    assert pkreg.select("mul", sig) is None
    # meta tensors (build-time shape inference) never route; CUDA does
    monkeypatch.setattr(pkreg, "_ROUTE_ON_CPU", True)
    assert not pkreg.routable("mul", torch.device("meta"))
    assert pkreg.select("mul", _sig("mul", (128, 128), (128, 128),
                                    device="meta")) is None
    assert pkreg.routable("mul", "cuda")
    assert pkreg.routable("mul", "cpu")
    assert not pkreg.routable("softmax", "cpu")   # no kernel for it
    # nothing was counted where routing was impossible
    assert pkreg.dispatch_stats()["decisions"] == 0
    # and the mul lowering keeps torch.matmul: bit-equal to x @ y
    monkeypatch.setattr(pkreg, "_ROUTE_ON_CPU", False)
    x, y = (torch.from_numpy(a) for a in _np_inputs(1, (128, 256),
                                                    (256, 128)))
    env = _lower("mul", {"X": x, "Y": y}, {})
    assert torch.equal(env, x @ y)


def test_first_eligible_wins(route):
    calls = []

    def kern(name, ok):
        def run(x, y, out_dtype=None):
            calls.append(name)
            return x @ y
        pkreg.register_kernel(name, op_types=("matmul",),
                              eligible=lambda sig: ok(sig), run=run)

    kern("first", lambda sig: sig.shapes[0][0] == 128)
    kern("second", lambda sig: True)
    sig_a = _sig("matmul", (128, 128), (128, 128))
    sig_b = _sig("matmul", (64, 128), (128, 128))
    # quantized_matmul comes first and is not opted in
    assert [k.name for k in pkreg._BY_OP["matmul"]] == [
        "quantized_matmul", "first", "second"]
    assert pkreg.select("matmul", sig_a).name == "first"
    assert pkreg.select("matmul", sig_b).name == "second"
    stats = pkreg.dispatch_stats()
    assert stats["per_kernel"]["first"] == {"custom": 1, "lowered": 1}
    assert stats["per_kernel"]["second"] == {"custom": 1}
    assert stats["custom"] == 2 and stats["decisions"] == 5
    assert "matmul" in pkreg.candidate_op_types()
    # re-registering moves a kernel to the end of its op's list
    kern("first", lambda sig: True)
    assert pkreg.select("matmul", sig_a).name == "second"
    assert pkreg.get("first") is not None
    # the name table keeps first-registration order, as the JAX one does
    assert pkreg.kernel_names()[-2:] == ["first", "second"]


_DECISIONS = [
    # (env, op, shapes, dtype)
    ({}, "mul", ((256, 256), (256, 256)), "float32"),
    ({"PT_KERNEL_QUANT_MATMUL": "int8"}, "mul", ((256, 256), (256, 256)),
     "float32"),
    ({"PT_KERNEL_QUANT_MATMUL": "bf16"}, "matmul", ((128, 384), (384, 256)),
     "bfloat16"),
    ({"PT_KERNEL_QUANT_MATMUL": "int8"}, "mul", ((96, 256), (256, 256)),
     "float32"),
    ({"PT_KERNEL_QUANT_MATMUL": "int8", "PT_KERNEL_DENY": "quantized_matmul"},
     "mul", ((256, 256), (256, 256)), "float32"),
    ({"PT_KERNEL_QUANT_MATMUL": "nonsense"}, "mul", ((256, 256), (256, 256)),
     "float32"),
]


@pytest.mark.parametrize("env,op,shapes,dtype", _DECISIONS)
def test_same_decision_as_the_jax_registry(route, monkeypatch, env, op,
                                          shapes, dtype):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jsel = jkreg.select(op, jkreg.signature(
        op, *[jnp.zeros(s, jdt) for s in shapes]))
    psel = pkreg.select(op, pkreg.signature(
        op, *[torch.zeros(s, dtype=getattr(torch, dtype)) for s in shapes]))
    assert (psel and psel.name) == (jsel and jsel.name)
    assert pkreg.dispatch_stats()["per_kernel"] == \
        {k: v for k, v in jkreg.dispatch_stats()["per_kernel"].items()
         if k == "quantized_matmul"}


# ---------------------------------------------------------------------------
# quantized_matmul: the port's plain version vs the JAX kernel (interpret)
# ---------------------------------------------------------------------------

_QMM_SHAPES = [(256, 384, 128), (128, 128, 128), (384, 256, 256)]


def _jax_quantized(x, y, mode):
    return np.asarray(jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(y),
                                           mode=mode))


def _jax_tile_quantize(v):
    """The JAX kernel's per-tile scale and rounding, tile by tile."""
    R, C = v.shape
    v = jnp.asarray(v)
    q = np.zeros((R, C), np.float32)
    s = np.zeros((R // 128, C // 128), np.float32)
    for i in range(R // 128):
        for j in range(C // 128):
            t = v[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128]
            sc = jnp.maximum(jnp.max(jnp.abs(t)), 1e-30) / 127.0
            s[i, j] = np.asarray(sc)
            q[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = np.asarray(
                jnp.clip(jnp.round(t / sc), -127, 127))
    return s, q


@pytest.mark.parametrize("M,K,N", _QMM_SHAPES)
def test_int8_scales_and_quantized_values_equal_jax(M, K, N):
    x, = _np_inputs(M + K, (M, K))
    x[0, 0] = 0.0          # a zero and a tie-prone value in the data
    x[1, :] *= 50.0        # one row that sets its tiles' scales
    js, jq = _jax_tile_quantize(x)
    ps = pqm.tile_scales(torch.from_numpy(x))
    pq = pqm.quantize_int8(torch.from_numpy(x), ps)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pq.numpy(), jq)


@pytest.mark.parametrize("mode,tol", [("int8", INT8_RTOL),
                                      ("bf16", BF16_RTOL)])
@pytest.mark.parametrize("M,K,N", _QMM_SHAPES)
def test_quantized_matmul_matches_jax_interpret(M, K, N, mode, tol):
    x, y = _np_inputs(M * N + K, (M, K), (K, N))
    ref = _jax_quantized(x, y, mode)
    got = pqm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(y),
                               mode=mode)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(ref, got.numpy()) <= tol
    # it really quantized: far from float32, within the parity bound
    f32 = x @ y
    assert 0 < _rel(f32, got.numpy()) <= {"int8": 5e-2, "bf16": 1e-2}[mode]


@pytest.mark.parametrize("mode,tol", [("int8", INT8_RTOL),
                                      ("bf16", BF16_RTOL)])
def test_quantized_matmul_bf16_operands_and_out_dtype(mode, tol):
    x, y = _np_inputs(5, (256, 256), (256, 128))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy = jnp.asarray(y).astype(jnp.bfloat16)
    ref = np.asarray(jqm.quantized_matmul(jx, jy, mode=mode))
    px = torch.from_numpy(x).to(torch.bfloat16)
    py = torch.from_numpy(y).to(torch.bfloat16)
    got = pqm.quantized_matmul(px, py, mode=mode, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(ref, pqm.quantized_matmul(px, py, mode=mode).numpy()) <= tol
    with pytest.raises(ValueError, match="multiples of 128"):
        pqm.quantized_matmul(px[:100], py, mode=mode)
    with pytest.raises(ValueError, match="unknown mode"):
        pqm.quantized_matmul(px, py, mode="fp8")


def test_quantized_matmul_mode_defaults(monkeypatch):
    x, y = (torch.from_numpy(a) for a in _np_inputs(9, (128, 128),
                                                    (128, 128)))
    monkeypatch.delenv("PT_KERNEL_QUANT_MATMUL", raising=False)
    bf = pqm.quantized_matmul(x, y)                      # default bf16
    assert torch.equal(bf, pqm.quantized_matmul_plain(x, y, "bf16"))
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "int8")
    assert torch.equal(pqm.quantized_matmul(x, y),
                       pqm.quantized_matmul_plain(x, y, "int8"))
    pkreg.reset_counts()
    pqm.quantized_matmul(x, y)
    assert pkreg.launches()["quantized_matmul_int8"] == 0   # CPU: plain


# ---------------------------------------------------------------------------
# mul and matmul through the lowerings, both packages routed
# ---------------------------------------------------------------------------

class _Op:
    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self._inputs = {s: [s.lower()] for s in inputs}
        self._outputs = {s: [s.lower() + "_out"] for s in outputs}
        self._attrs = dict(attrs)

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return list(self._outputs)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def all_attrs(self):
        return dict(self._attrs)


def _lower(op_type, inputs, attrs):
    """The port's lowering on CPU tensors: returns Out."""
    op = _Op(op_type, inputs, ["Out"], attrs)
    env = {s.lower(): v for s, v in inputs.items()}
    PT_OPS.get(op_type).lowering(PtContext(op, env, torch.device("cpu")))
    return env["out_out"]


def _lower_jax(op_type, inputs, attrs):
    op = _Op(op_type, inputs, ["Out"], attrs)
    env = {s.lower(): jnp.asarray(v) for s, v in inputs.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, env))
    return np.asarray(env["out_out"])


_OP_CASES = [
    # (op, input shapes, attrs, routed)
    ("mul", ((2, 128, 256), (256, 128)), {"x_num_col_dims": 2}, True),
    ("mul", ((128, 2, 128), (256, 128)), {"x_num_col_dims": 1}, True),
    ("mul", ((128, 256), (256, 384)), {}, True),
    ("matmul", ((256, 128), (128, 256)), {}, True),
    ("matmul", ((256, 128), (256, 128)), {"transpose_Y": True}, True),
    ("matmul", ((128, 256), (128, 128)), {"transpose_X": True}, True),
    ("matmul", ((256, 128), (128, 256)), {"alpha": 0.5}, False),
    ("matmul", ((2, 128, 128), (2, 128, 128)), {}, False),   # batched
    ("matmul", ((128,), (128, 256)), {}, False),             # 1-row
]


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("op_type,shapes,attrs,routed", _OP_CASES)
def test_op_lowering_routes_like_jax(route, monkeypatch, mode, op_type,
                                     shapes, attrs, routed):
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", mode)
    x, y = _np_inputs(len(shapes[0]) * 7 + shapes[1][-1], *shapes)
    ref = _lower_jax(op_type, {"X": x, "Y": y}, attrs)
    got = _lower(op_type, {"X": torch.from_numpy(x),
                           "Y": torch.from_numpy(y)}, attrs)
    assert got.shape == ref.shape
    tol = INT8_RTOL if mode == "int8" else BF16_RTOL
    if not routed:
        tol = 1e-6     # float32 on both sides, another summation order
    assert _rel(ref, got.numpy()) <= tol
    stats = pkreg.dispatch_stats()["per_kernel"]
    assert stats.get("quantized_matmul", {}).get("custom", 0) == int(routed)


@pytest.mark.parametrize("op_type,shapes,attrs,routed", _OP_CASES)
def test_op_lowering_float32_matches_jax(op_type, shapes, attrs, routed):
    x, y = _np_inputs(3, *shapes)
    ref = _lower_jax(op_type, {"X": x, "Y": y}, attrs)
    got = _lower(op_type, {"X": torch.from_numpy(x),
                           "Y": torch.from_numpy(y)}, attrs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_layers_matmul_in_a_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = pt.layers.data(name="a", shape=[4, 8], dtype="float32",
                           append_batch_size=False)
        b = pt.layers.data(name="b", shape=[6, 8], dtype="float32",
                           append_batch_size=False)
        out = pt.layers.matmul(a, b, transpose_y=True, alpha=2.0)
    assert out.shape == (4, 6)
    op = main.global_block().ops[-1]
    assert op.type == "matmul" and op.attr("transpose_Y") is True
    av, bv = _np_inputs(4, (4, 8), (6, 8))
    res, = pt.Executor(pt.CPUPlace()).run(main, feed={"a": av, "b": bv},
                                          fetch_list=[out],
                                          scope=pt.Scope())
    np.testing.assert_allclose(res, 2.0 * av @ bv.T, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tuned_matmul: each epilogue vs the JAX kernel (interpret); the search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue,blocks,M,N,K", [
    ("none", (64, 64, 16), 256, 256, 256),
    ("none", (128, 128, 8), 256, 128, 256),
    ("layer_norm", (16, 256, 16), 256, 256, 256),
    ("layer_norm", (32, 512, 8), 64, 512, 128),
    ("dropout_residual", (128, 64, 16), 256, 256, 256),
    # tiles of the tensor-core design (tuned_matmul_sm90.cu)
    ("none", (128, 256, 32), 256, 256, 256),
    ("layer_norm", (64, 512, 16), 128, 512, 128),
    ("dropout_residual", (128, 128, 32), 256, 256, 256),
    ("dropout_residual", (128, 256, 32), 256, 256, 256),
    ("dropout_residual", (128, 256, 16), 256, 512, 128),
])
def test_tuned_epilogue_matches_jax_interpret(monkeypatch, epilogue, blocks,
                                              M, N, K):
    monkeypatch.setattr(jkreg, "_INTERPRET", True)
    jd = jvariants._problem(M, N, K)
    # the JAX kernel at a TPU blocking that divides the problem (the
    # blocking does not change the function)
    jv = jvariants.Variant(min(M, 128), N if epilogue == "layer_norm"
                           else 128, 128, epilogue)
    ref = np.asarray(jvariants._run_variant(jv, jd))
    pd = pvariants._problem(M, N, K, torch.device("cpu"))
    for k in jd:
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jd[k]))
    got = pvariants._run_variant(pvariants.Variant(*blocks, epilogue), pd)
    assert _rel(ref, got.numpy()) <= TUNED_RTOL


# ---------------------------------------------------------------------------
# 3xTF32 (the tensor-core design's arithmetic), in plain numpy
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero (the magnitude's bits plus half of the
    dropped 13, then the 13 cleared), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x1000) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def _split_tf32(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)           # tf32's step at 1
    x = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4,
                  -(1 + ulp / 2), 1 + ulp * 1.5], np.float32)
    np.testing.assert_array_equal(
        _tf32_rna(x), np.array([one, one + ulp, one + ulp, -(one + ulp),
                                one + 2 * ulp], np.float32))
    hi, lo = _split_tf32(np.float32(np.pi))
    assert hi == _tf32_rna(hi) and lo == _tf32_rna(lo)
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) <= \
        2.0 ** -21 * np.pi


@pytest.mark.parametrize("K", [512, 2048])
def test_three_tf32_products_keep_float32_accuracy(K):
    """lo.hi + hi.lo + hi.hi (lo.lo dropped) is within GEMM_RTOL of the
    float32 product at the serving depths, where one TF32 product
    (hi.hi) is not. The tensor cores round their float32 sums toward
    zero: one such sum over all of K = 2048 drifts beyond GEMM_RTOL, so
    the kernel adds each 32-deep stage's products to its sum as a fresh
    partial, which keeps it within."""
    r = np.random.default_rng(K)
    x = r.standard_normal((64, K), dtype=np.float32)
    x[::7] *= 30.0
    y = (r.standard_normal((K, 128)) * K ** -0.5).astype(np.float32)
    ref = x @ y                                      # float32
    xh, xl = _split_tf32(x)
    yh, yl = _split_tf32(y)
    f64 = (lambda a: a.astype(np.float64))
    three = f64(xl) @ f64(yh) + f64(xh) @ f64(yl) + f64(xh) @ f64(yh)
    assert _rel(ref, three) <= GEMM_RTOL
    assert _rel(ref, f64(xh) @ f64(yh)) > 10 * GEMM_RTOL

    def toward_zero(v):                              # float64 -> float32
        f = v.astype(np.float32)
        return np.where(np.abs(f.astype(np.float64)) > np.abs(v),
                        np.nextafter(f, np.float32(0)), f)

    def tensor_core_sum(stage):
        """The products of each `stage` columns of K summed rounding
        toward zero a k8 step, the stages' sums added to nearest."""
        total = np.zeros(ref.shape, np.float32)
        for k0 in range(0, K, stage):
            part = np.zeros(ref.shape, np.float32)
            for k in range(k0, k0 + stage, 8):
                s = slice(k, k + 8)
                for a, b in ((xl, yh), (xh, yl), (xh, yh)):
                    part = toward_zero(f64(part) + f64(a[:, s]) @ f64(b[s]))
            total = total + part
        return total

    assert _rel(ref, tensor_core_sum(32)) <= GEMM_RTOL
    if K == 2048:
        assert _rel(ref, tensor_core_sum(K)) > GEMM_RTOL


def test_tuned_matmul_checks_its_operands():
    d = pvariants._problem(256, 256, 256, torch.device("cpu"))
    ln = pvariants.Variant(16, 256, 16, "layer_norm")
    with pytest.raises(ValueError, match="needs its two operands"):
        pvariants.tuned_matmul(d["x"], d["y"], variant=ln)
    with pytest.raises(ValueError, match="full rows"):
        pvariants.tuned_matmul(d["x"], d["y"],
                               variant=pvariants.Variant(16, 128, 16,
                                                         "layer_norm"),
                               gamma=d["gamma"], beta=d["beta"])
    with pytest.raises(ValueError, match="does not divide"):
        pvariants.tuned_matmul(d["x"][:100], d["y"],
                               variant=pvariants.Variant(64, 64, 16, "none"))


def test_variant_enumeration_respects_constraints():
    vs = pvariants.enumerate_variants(256, 256, 256)
    assert {v.epilogue for v in vs} == {"none", "layer_norm",
                                        "dropout_residual"}
    for v in vs:
        assert 256 % v.bm == 0 and 256 % v.bn == 0 and 256 % v.bk == 0
        if v.epilogue == "layer_norm":
            assert v.bn == 256
    # layer_norm variants exist at the JAX default N and at d_model
    for n in (256, 512):
        assert any(v.epilogue == "layer_norm" and v.bn == n
                   for v in pvariants.enumerate_variants(256, n, 256))
    # every serving GEMM shape takes every none tile of both designs
    for (M, K, N) in ((8192, 512, 512), (8192, 512, 2048),
                      (8192, 2048, 512), (8192, 512, 32000)):
        assert {(v.bm, v.bn, v.bk) for v in
                pvariants.enumerate_variants(M, N, K)
                if v.epilogue == "none"} == set(pvariants._BLOCKS["none"])
    # the tensor-core tiles: 3 for none and for dropout_residual, and one
    # layer_norm tile with bn == N at N = 256 and at d_model
    sm90 = {ep: {(v.bm, v.bn, v.bk) for n in (256, 512)
                 for v in pvariants.enumerate_variants(8192, n, 512)
                 if v.epilogue == ep and v.sm90}
            for ep in ("none", "layer_norm", "dropout_residual")}
    assert sm90 == {"none": set(pvariants._SM90_BLOCKS["none"]),
                    "layer_norm": {(64, 256, 32), (64, 512, 16)},
                    "dropout_residual": {(128, 128, 32), (128, 256, 32),
                                         (128, 256, 16)}}
    for v in pvariants.enumerate_variants(8192, 512, 512):
        assert v.kernel == {"none": "tuned_matmul",
                            "layer_norm": "tuned_matmul_ln",
                            "dropout_residual": "tuned_matmul_dr"}[
            v.epilogue] + ("_sm90" if v.sm90 else "")
        assert v.kernel in pkreg.SOURCES


def test_variant_cases_pass_on_cpu():
    for v, case in pvariants.variant_cases(256, 512, 128):
        res = pparity.run_case(case, device="cpu")
        assert res["passed"] and res["kernel"].startswith("tuned_matmul")


def test_search_variants_on_cpu_reports_no_time():
    res = pvariants.search_variants(256, 256, 256, device="cpu")
    assert res["timed"] is False and res["device"] == "cpu"
    assert res["considered"] == len(res["admitted"]) == len(
        pvariants.enumerate_variants(256, 256, 256))
    assert all(r["ms"] is None and r["rel_err"] <= TUNED_RTOL
               for r in res["admitted"])
    assert res["winners"] == {}
    assert pvariants.register_winner(res["winners"]) is None


def test_register_winner_routes_only_plain_gemm(route, monkeypatch):
    winners = {"none": {"bm": 64, "bn": 128, "bk": 16, "ms": 0.5},
               "layer_norm": {"bm": 16, "bn": 256, "bk": 16, "ms": 0.7}}
    assert pvariants.register_winner(winners) == "tuned_matmul"
    kern = pkreg.get("tuned_matmul")
    sig = _sig("matmul", (256, 256), (256, 256))
    assert kern.eligible(sig)
    assert not kern.eligible(_sig("matmul", (250, 256), (256, 256)))
    assert not kern.eligible(_sig("matmul", (256, 256), (256, 256),
                                  dtype="bfloat16"))
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "65536")
    small = _sig("matmul", (128, 256), (256, 128))
    assert small.numel < pkreg.min_numel() and not kern.eligible(small)
    assert sig.numel == pkreg.min_numel() and kern.eligible(sig)
    # the JAX package decides the same on the same gates
    jvariants.register_winner({"none": {"bm": 64, "bn": 128, "bk": 128}})
    jsig = jkreg.Signature(op_type="matmul", shapes=((256, 256), (256, 256)),
                           dtypes=("float32", "float32"))
    assert jkreg.get("tuned_matmul").eligible(jsig) == kern.eligible(sig)
    # routed through mul: quantized_matmul (not opted in) first, then it
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    x, y = (torch.from_numpy(a) for a in _np_inputs(8, (128, 256),
                                                    (256, 128)))
    out = _lower("mul", {"X": x, "Y": y}, {})
    assert pkreg.dispatch_stats()["per_kernel"]["tuned_matmul"] == {
        "custom": 1}
    np.testing.assert_allclose(out.numpy(), (x @ y).numpy(), rtol=1e-6)


@pytest.mark.parametrize("label", [c.label for c in pparity.cases()])
def test_parity_cases_pass_on_cpu(label):
    case, = [c for c in pparity.cases() if c.label == label]
    res = pparity.run_case(case, device="cpu")
    assert res["passed"], res


# ---------------------------------------------------------------------------
# a tiny Transformer in int8 and bf16 mode through both Executors
# ---------------------------------------------------------------------------

B, S = 4, 32                  # B * S = 128
SRC_LENS = np.array([32, 20, 27, 9], np.int32)
TRG_LENS = np.array([32, 31, 12, 25], np.int32)


def _cfg(mod):
    cfg = mod.transformer_base(src_vocab_size=384, trg_vocab_size=384,
                               fuse_attention=True)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 128, 256
    cfg.n_head, cfg.d_head = 4, 32
    return cfg


def _batch(mod, cfg, seed):
    return mod.make_batch(cfg, B, S, S, rng=np.random.default_rng(seed),
                          src_lens=SRC_LENS, trg_lens=TRG_LENS)


@pytest.fixture(scope="module")
def tiny_transformers():
    cfg = _cfg(jax_transformer)
    fluid.framework.unique_name.reset()
    jmain, jstartup = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstartup):
        jcost, jlogits, _ = jax_transformer.transformer_train(cfg,
                                                              is_test=True)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pcfg = _cfg(pt_transformer)
    pt.framework.unique_name.reset()
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup):
        pcost, plogits, _ = pt_transformer.transformer_train(pcfg,
                                                             is_test=True)
    pscope = pt.Scope()
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    return {"jax": (jexe, jmain, jscope, jlogits, jcost, cfg),
            "port": (pt.Executor(pt.CPUPlace()), pmain, pscope, plogits,
                     pcost, pcfg)}


def _score(side, mod, seed):
    exe, main, scope, logits, cost, cfg = side
    lg, c = exe.run(main, feed=_batch(mod, cfg, seed),
                    fetch_list=[logits, cost], scope=scope)
    return np.asarray(lg), float(np.asarray(c))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_tiny_transformer_quantized_matches_jax(tiny_transformers, route,
                                                monkeypatch, mode):
    ops = [op.type for op in tiny_transformers["port"][1].global_block().ops]
    n_mul, n_attn = ops.count("mul"), ops.count("fused_attention")
    f32_port = _score(tiny_transformers["port"], pt_transformer, 3)
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", mode)
    pkreg.reset_stats()
    jl, jc = _score(tiny_transformers["jax"], jax_transformer, 3)
    pl, pc = _score(tiny_transformers["port"], pt_transformer, 3)
    # every mul of the port's forward went to the kernel's wrapper; the
    # attention ops ran their plain version on the CPU (lowered)
    assert pkreg.dispatch_stats()["per_kernel"] == {
        "quantized_matmul": {"custom": n_mul},
        "flash_attention": {"lowered": n_attn}}
    assert pl.shape == jl.shape == (B, S, 384)
    assert np.isfinite(pl).all() and np.isfinite(pc)
    assert _rel(jl, pl) <= TF_LOGITS_RTOL[mode]
    assert abs(pc - jc) <= TF_COST_ATOL[mode]
    # quantized, and within the parity bound of the float32 forward
    assert 0 < _rel(f32_port[0], pl) <= {"int8": 5e-2, "bf16": 1e-2}[mode]


# ---------------------------------------------------------------------------
# a gradient through a forward-only kernel raises, in both packages
# ---------------------------------------------------------------------------

def _train_program(mod_layers, mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod_layers.data(name="x", shape=[128], dtype="float32")
        w = mod.ParamAttr(initializer=mod.initializer.Normal(0.0, 0.05))
        h = mod_layers.fc(x, 128, param_attr=w, bias_attr=False)
        loss = mod_layers.reduce_sum(mod_layers.elementwise_mul(h, h))
    return main, startup, loss


@pytest.mark.parametrize("kernel", ["int8", "tuned"])
def test_gradient_through_a_forward_only_kernel_raises(route, monkeypatch,
                                                       kernel):
    if kernel == "int8":
        monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "int8")
        want = "quantized_matmul_int8 is a forward-only kernel"
    else:
        pvariants.register_winner({"none": {"bm": 64, "bn": 64, "bk": 16}})
        jvariants.register_winner({"none": {"bm": 64, "bn": 128,
                                            "bk": 128}})
        want = "tuned_matmul is a forward-only kernel"
    xv, = _np_inputs(2, (128, 128))
    # the JAX package refuses to differentiate its Pallas kernel
    main, startup, loss = _train_program(fluid.layers, fluid)
    with fluid.program_guard(main, startup):
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = JaxScope()
    jexe.run(startup, scope=jscope)
    with pytest.raises(Exception, match="mul_grad"):
        jexe.run(main, feed={"x": xv}, fetch_list=[loss], scope=jscope)
    # the port raises too, naming the kernel, instead of a zero gradient
    pt.framework.unique_name.reset()
    main, startup, loss = _train_program(pt.layers, pt)
    with pt.program_guard(main, startup):
        pt.optimizer.AdamOptimizer(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception, match=want):
        exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)
    # a forward-only program through the same kernel runs
    pt.framework.unique_name.reset()
    fwd, fstart, floss = _train_program(pt.layers, pt)
    exe.run(fstart, scope=scope)
    pkreg.reset_stats()
    val, = exe.run(fwd, feed={"x": xv}, fetch_list=[floss], scope=scope)
    assert np.isfinite(val)
    assert pkreg.dispatch_stats()["custom"] == 1


def test_forward_only_wrapper_passes_values_and_refuses_gradients():
    x = torch.randn(128, 128, requires_grad=True)
    y = torch.randn(128, 128)
    out = pkreg.forward_only("k", lambda a, b: a.detach() @ b, x, y)
    assert out.requires_grad
    assert torch.allclose(out, x.detach() @ y)
    with pytest.raises(RuntimeError, match="k is a forward-only kernel"):
        out.sum().backward()
    with torch.no_grad():
        assert not pkreg.forward_only("k", lambda a, b: a @ b, x,
                                      y).requires_grad


def test_training_without_opt_in_routes_nothing(route):
    """With no knob set and no winner, a training step routes no GEMM
    and its gradient is the float32 one; only the Adam updates (a
    registry kernel since Adam honours the registry) route, one a
    parameter at this floor of 1."""
    pt.framework.unique_name.reset()
    main, startup, loss = _train_program(pt.layers, pt)
    with pt.program_guard(main, startup):
        pt.optimizer.AdamOptimizer(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    xv, = _np_inputs(2, (128, 128))
    val, = exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)
    assert np.isfinite(val)
    stats = pkreg.dispatch_stats()["per_kernel"]
    assert stats.pop("fused_adam") == {"custom": len(main.all_parameters())}
    assert stats and all(v.get("custom", 0) == 0 for v in stats.values())
