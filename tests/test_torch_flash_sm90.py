"""Which attention kernel design a call takes, the bf16 path on the CPU,
and the bound a bf16 backward meets.

The wrappers send a bf16 call to the tensor-core kernels
(csrc/flash_attention_fwd_sm90.cu, flash_attention_bwd_dq_sm90.cu,
flash_attention_bwd_dkv_sm90.cu), and a float32 forward to the 3xTF32
tensor-core forward (csrc/flash_attention_fwd_f32_sm90.cu), when
_sm90_eligible holds: TMA's rules for q, k, v and out (or dout), all of
one dtype, rows of 16-byte multiples (D % 8 == 0 in bf16, D % 4 == 0 in
float32) at most 128 wide, 16-byte-aligned bases, strides multiples of
16 bytes. Every other call on the card takes the CUDA-core kernels, and
so does every float32 backward. _sm90_eligible reads dtypes, shapes,
pointers and strides only, so it is tested here on CPU tensors: every
case shape of chip_smoke.py in both layouts, misaligned and mixed-dtype
inputs.

A bf16 CPU tensor still takes the plain versions (bit for bit), and
those hold against the JAX package's Pallas kernels in interpret mode on
the same bf16 inputs within BF16_TOL = 2e-2 (p, ds and the outputs
round to bf16 at other places). The kernels themselves are held against
the plain versions on the card in tests/test_torch_cuda.py and
chip_smoke.py.

flash_attention.bf16_backward_bound (what a correct bf16 dq, dk, dv
meets against the exact gradients: 2^-8 of ds's or p_drop's
contribution and of the result) holds for the plain version on the
CPU, rows whose keys are all padded included, and a dq that lost one
key's term or rounded ds to 6 bits breaks it.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import registry as kreg
from torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

BF16_TOL = 2e-2

# chip_smoke.py's case shapes: (B, H, Sq, Sk, D)
_SHAPES = [(4, 8, 256, 256, 64), (4, 8, 192, 256, 64), (2, 8, 128, 160, 64),
           (3, 4, 77, 77, 96), (2, 3, 50, 130, 128), (4, 8, 128, 128, 64),
           (32, 8, 256, 256, 64), (96, 8, 128, 128, 64), (3, 2, 77, 77, 40)]
_LAYOUTS = ["bshd", "bhsd"]


def _qkv(layout, B, H, Sq, Sk, D, dtype=torch.bfloat16):
    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return torch.empty(shape, dtype=dtype)

    return t(Sq), t(Sk), t(Sk), t(Sq)


@pytest.mark.parametrize("dtype,sm90", [(torch.bfloat16, True),
                                        (torch.float32, True)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("B,H,Sq,Sk,D", _SHAPES)
def test_case_shapes_take_the_design_of_their_dtype(B, H, Sq, Sk, D, layout,
                                                    dtype, sm90):
    """bf16: the tensor-core kernels; float32: the tensor-core (3xTF32)
    forward (its backward keeps the CUDA-core kernels)."""
    q, k, v, out = _qkv(layout, B, H, Sq, Sk, D, dtype)
    assert pfa._sm90_eligible(q, k, v, out, layout) is sm90


@pytest.mark.parametrize("which", range(4))
def test_a_misaligned_slice_takes_the_cuda_core_kernels(which):
    """One of q, k, v, out starts 2 bytes past a 16-byte boundary: still
    a contiguous tensor the CUDA-core kernels take, but not TMA."""
    B, S, H, D = 2, 64, 4, 64
    ts = list(_qkv("bshd", B, H, S, S, D))
    base = torch.empty(ts[which].numel() + 1, dtype=torch.bfloat16)
    ts[which] = base[1:].view(B, S, H, D)
    assert ts[which].is_contiguous() and ts[which].data_ptr() % 16 == 2
    assert not pfa._sm90_eligible(*ts, "bshd")


@pytest.mark.parametrize("D", [4, 36, 100, 136])
def test_head_dims_tma_cannot_take(D):
    """D not a multiple of 8 (rows of 16-byte multiples) or above 128."""
    q, k, v, out = _qkv("bshd", 2, 2, 16, 16, D)
    assert not pfa._sm90_eligible(q, k, v, out, "bshd")


def test_a_stride_off_16_bytes_is_refused():
    """A view whose sequence stride is 9 elements (18 bytes)."""
    base = torch.empty(2, 16, 1, 9, dtype=torch.bfloat16)
    q = base[..., :8]
    _, k, v, out = _qkv("bshd", 2, 1, 16, 16, 8)
    assert not pfa._sm90_eligible(q, k, v, out, "bshd")
    assert pfa._sm90_eligible(*_qkv("bshd", 2, 1, 16, 16, 8), "bshd")


@pytest.mark.parametrize("which", range(4))
def test_one_float32_tensor_among_bf16_is_refused(which):
    """The TMA maps are bf16: every one of the four tensors must be."""
    ts = list(_qkv("bshd", 2, 2, 16, 16, 64))
    ts[which] = ts[which].float()
    assert not pfa._sm90_eligible(*ts, "bshd")


def test_new_sources_are_registered_and_export_their_symbols():
    for name, symbol in (("flash_attention_fwd_sm90",
                          "pt_flash_attention_fwd_sm90"),
                         ("flash_attention_bwd_dkv_sm90",
                          "pt_flash_attention_bwd_dkv_sm90")):
        src = (kreg.CSRC / kreg.SOURCES[name]).read_text()
        assert f'extern "C" int {symbol}(' in src
        assert kreg.library_path(name).name.startswith(
            "lib" + kreg.SOURCES[name][:-3] + "-")
        assert name in kreg.launches()
    header = (kreg.CSRC / "flash_attention_sm90.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier"):
        assert ptx in header


def _np_inputs(seed, layout, B=2, H=2, Sq=24, Sk=24, D=16):
    rng = np.random.default_rng(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = t(Sq), t(Sk), t(Sk)
    lens = np.maximum(Sk - 5 * np.arange(B), 1)
    b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                 -1e9).astype(np.float32)[:, None, None, :]
    return q, k, v, b


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _jax_drop(dropout):
    if dropout is None:
        return None
    s0, s1, t = dropout
    return jnp.asarray(np.array([s0, s1], np.uint32)), t


_BF16_CASES = [("bshd", 24, 24, False, None),
               ("bshd", 24, 24, True, (0x12345678, 0x9ABCDEF0, 230)),
               ("bhsd", 16, 24, False, (7, 11, 128)),
               ("bhsd", 24, 24, True, None)]


@pytest.mark.parametrize("layout,Sq,Sk,causal,dropout", _BF16_CASES)
def test_bf16_cpu_path_is_plain_and_matches_jax_kernels(
        layout, Sq, Sk, causal, dropout, monkeypatch):
    """A bf16 call on the CPU never reaches a kernel, returns the plain
    versions' results bit for bit, and agrees with the JAX package's
    _fa_forward / _fa_backward (interpret mode) on the same bf16 inputs."""
    def _no_launch(*a, **k):
        raise AssertionError("a CUDA kernel was launched for CPU input")

    monkeypatch.setattr(pfa, "_launch", _no_launch)
    monkeypatch.setattr(pfa, "_launch_bwd", _no_launch)
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _np_inputs(11, layout, Sq=Sq, Sk=Sk)
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    qt, kt, vt, gt = (_bf16(a) for a in (q, k, v, g))
    bt = torch.from_numpy(b)
    scale = 16 ** -0.5
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(qt, kt, vt, bt, scale, causal,
                                           layout, return_lse=True,
                                           dropout=dropout)
    ref, ref_lse = pfa.fused_attention_plain(qt, kt, vt, bt, scale, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    grads = pfa.fused_attention_backward(qt, kt, vt, bt, out, lse, gt, scale,
                                         causal, layout, dropout=dropout)
    plain = pfa.fused_attention_backward_plain(qt, kt, vt, bt, out, lse, gt,
                                               scale, causal, layout,
                                               dropout=dropout)
    for a, r in zip(grads[:3], plain[:3]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, r)
    assert not any(kreg.launches().values())

    jargs = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
             for t in (qt, kt, vt)] + [jnp.asarray(b)]
    jd = _jax_drop(dropout)
    jo, jl = jfa._fa_forward(*jargs, scale, Sq, Sk, return_lse=True,
                             layout=layout, causal=causal, dropout=jd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jo, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=BF16_TOL,
                               atol=BF16_TOL)
    want = jfa._fa_backward(*jargs, jo, jl,
                            jnp.asarray(g, dtype=jnp.bfloat16), scale, Sq,
                            Sk, layout=layout, causal=causal, dropout=jd)
    # the port's backward again from the JAX forward's out and lse
    got = pfa.fused_attention_backward(
        qt, kt, vt, bt, torch.from_numpy(np.array(jo, np.float32))
        .bfloat16(), torch.from_numpy(np.array(jl)), gt, scale, causal,
        layout, dropout=dropout)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("name,symbol", [
    ("flash_attention_bwd_dq_sm90", "pt_flash_attention_bwd_dq_sm90"),
    ("quantized_matmul_int8", "pt_quantized_matmul")])
def test_tensor_core_sources_of_this_slice(name, symbol):
    """The tensor-core dq and quantized GEMM sources are registered, export
    their entry point and use wgmma and TMA (the quantized GEMM also the
    mbarrier ring); the dq source computes di itself (no di pre-pass)."""
    src = (kreg.CSRC / kreg.SOURCES[name]).read_text()
    assert f'extern "C" int {symbol}(' in src
    assert name in kreg.launches()
    for ptx in ("wgmma.mma_async" if "quantized" in name else "wgmma_",
                "tma_load"):
        assert ptx in src
    if name == "flash_attention_bwd_dq_sm90":
        # one kernel, which writes di for the dk/dv kernel itself
        assert src.count("__global__") == 1 and "p.di[" in src


def _check_bf16_bound(dropout, D, S):
    """The plain bf16 backward meets bf16_backward_bound over seeded
    draws of dO (rows whose keys are all padded included); a dq whose ds
    skipped one key's contribution, or was rounded to 6 bits, does not."""
    rng = np.random.default_rng(40)
    B, H = 2, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).bfloat16() for _ in range(3))
    b = torch.zeros(B, 1, 1, S)
    b[-1] = -1e9                       # every key of the last row padded
    scale = D ** -0.5
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, False, "bshd",
                                         return_lse=True, dropout=dropout)
    for seed in range(8):
        g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            q.shape).astype(np.float32)).bfloat16()
        got = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, g,
                                                 scale, False, "bshd",
                                                 dropout=dropout)
        exact, bound = pfa.bf16_backward_bound(q, k, v, b, out, lse, g,
                                               scale, False, "bshd", dropout)
        for a, e, bd in zip(got[:3], exact, bound):
            assert ((a.double() - e).abs() <= bd).all()
        # where all keys are padded the bound is wider than BF16_TOL
        assert bound[0][-1].max() > BF16_TOL
    # one key's term missing from dq: beyond the bound
    kd = k.double()
    wrong = exact[0] - scale * 0.5 * kd[:, :1] * exact[0].abs().amax()
    assert ((wrong - exact[0]).abs() > bound[0]).any()
    # ds rounded to 6 bits instead of 8: beyond it too
    coarse = exact[0] * (1 + 2.0 ** -5)
    assert ((coarse - exact[0]).abs() > bound[0]).any()


def test_bf16_bound_holds_where_the_dot_products_cancel():
    """Row 0 of a causal head sees one key: p = 1, exact ds = 0 (dp = di)
    and the float32 dq is rounding alone, scaled by magnitudes that the
    dot products dp = dO.v and di = dO.O cancel. The plain bf16 backward
    meets the bound there (the card test's D = 264 case, whose element
    (0, 0, 0, 0) exceeded the earlier forms by 5.8e-8)."""
    rng = np.random.default_rng(23)
    B, H, Sq, Sk, D = 2, 2, 96, 80, 264
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).bfloat16() for S in (Sq, Sk, Sk))
    lens = np.maximum(Sk - 5 * np.arange(B), 1)
    b = torch.from_numpy(np.where(np.arange(Sk)[None, :] < lens[:, None],
                                  0.0, -1e9).astype(np.float32)
                         [:, None, None, :])
    g = torch.from_numpy(np.random.default_rng(24).standard_normal(
        q.shape).astype(np.float32)).bfloat16()
    scale = D ** -0.5
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, True, "bshd",
                                         return_lse=True)
    got = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, g, scale,
                                             True, "bshd")
    exact, bound = pfa.bf16_backward_bound(q, k, v, b, out, lse, g, scale,
                                           True, "bshd")
    for a, e, bd in zip(got[:3], exact, bound):
        assert ((a.double() - e).abs() <= bd).all()
    # the case is exercised: exact dq of row 0 is 0, the float32 one not
    assert exact[0][:, 0].abs().max() == 0
    assert got[0][:, 0].abs().max() > 0


@pytest.mark.parametrize("dropout", [None, (7, 11, 128)],
                         ids=["nodrop", "t128"])
def test_bf16_bound_holds_for_the_plain_version_and_catches_errors(dropout):
    """bf16_backward_bound on the CPU at D = 32: the plain bf16 backward
    (which rounds ds and p_drop to bf16 as the kernels do) meets it, and
    it catches a skipped key and a coarser rounding."""
    _check_bf16_bound(dropout, D=32, S=32)


@pytest.mark.parametrize("dropout", [None, (7, 11, 128)],
                         ids=["nodrop", "t128"])
def test_bf16_bound_holds_above_head_dim_256(dropout):
    """The same at D = 264, where the CUDA-core kernels sum the scores
    over 128-column chunks and write 256-column groups of the
    gradients."""
    _check_bf16_bound(dropout, D=264, S=24)
