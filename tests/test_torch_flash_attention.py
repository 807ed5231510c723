"""fused_attention_plain (the CUDA kernel's plain PyTorch version) against
the JAX package's flash-attention forward, and the wrapper's routing.

The JAX side runs its Pallas kernel _fa_forward in interpret mode (as
tests/test_flash_attention_bwd.py does) and its composed _attn_reference.
Tolerance: float32 1e-5 relative and absolute (float32 sums in another
order); bf16 inputs 2e-2 against the float32 reference on the same
bf16-rounded inputs (p and out round to bf16).

The kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import registry as kreg

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL = ATOL = 1e-5
BF16_TOL = 2e-2


def _inputs(seed, layout, B=2, H=4, Sq=16, Sk=16, D=8, bias="key_pad",
            pad_all_row=False):
    """numpy q/k/v in `layout` and a bias: "none", "key_pad"
    [B,1,1,Sk] with -1e9 on padded keys, or "per_head" [B,H,Sq,Sk]."""
    rng = np.random.default_rng(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = t(Sq), t(Sk), t(Sk)
    if bias == "none":
        b = None
    elif bias == "key_pad":
        lens = np.maximum(Sk - 3 * np.arange(B), 1)
        if pad_all_row:
            lens[-1] = 0        # every key of the last batch row padded
        b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                     -1e9).astype(np.float32)[:, None, None, :]
    else:
        b = rng.standard_normal((B, H, Sq, Sk)).astype(np.float32)
    return q, k, v, b


def _plain(q, k, v, b, scale, causal, layout, return_lse=False):
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    out = pfa.fused_attention_plain(tt(q), tt(k), tt(v), tt(b), scale,
                                    causal, layout, return_lse)
    if return_lse:
        return out[0].numpy(), out[1].numpy()
    return out.numpy()


def _jax_kernel(q, k, v, b, scale, causal, layout, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    Sq = q.shape[1] if layout == "bshd" else q.shape[2]
    Sk = k.shape[1] if layout == "bshd" else k.shape[2]
    out, lse = jfa._fa_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), scale, Sq, Sk,
        return_lse=True, layout=layout, causal=causal)
    return np.asarray(out), np.asarray(lse)


_CASES = [
    # (layout, Sq, Sk, bias, causal, pad_all_row)
    ("bshd", 16, 16, "key_pad", False, False),
    ("bshd", 16, 16, "key_pad", True, False),
    ("bshd", 12, 16, "key_pad", False, False),     # cross, Sq != Sk
    ("bshd", 16, 24, "key_pad", True, False),      # causal, Sq != Sk
    ("bhsd", 16, 16, "per_head", False, False),
    ("bhsd", 8, 16, "per_head", True, False),
    ("bshd", 16, 16, "none", True, False),
    ("bshd", 16, 16, "key_pad", False, True),      # a fully padded row
    ("bhsd", 16, 8, "key_pad", True, True),
]
_IDS = ["-".join(map(str, c)) for c in _CASES]


@pytest.mark.parametrize("layout,Sq,Sk,bias,causal,pad_all", _CASES,
                         ids=_IDS)
def test_plain_matches_jax_kernel_interpret(layout, Sq, Sk, bias, causal,
                                            pad_all, monkeypatch):
    q, k, v, b = _inputs(0, layout, Sq=Sq, Sk=Sk, bias=bias,
                         pad_all_row=pad_all)
    scale = 8 ** -0.5
    jo, jl = _jax_kernel(q, k, v, b, scale, causal, layout, monkeypatch)
    po, pl = _plain(q, k, v, b, scale, causal, layout, return_lse=True)
    np.testing.assert_allclose(po, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout,Sq,Sk,bias,causal,pad_all", _CASES,
                         ids=_IDS)
def test_plain_matches_jax_reference(layout, Sq, Sk, bias, causal,
                                     pad_all):
    q, k, v, b = _inputs(1, layout, Sq=Sq, Sk=Sk, bias=bias,
                         pad_all_row=pad_all)
    scale = 0.3
    jo = np.asarray(jfa._attn_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), scale, layout=layout,
        causal=causal))
    po = _plain(q, k, v, b, scale, causal, layout)
    np.testing.assert_allclose(po, jo, rtol=RTOL, atol=ATOL)


def test_plain_bf16_matches_float32_reference():
    q, k, v, b = _inputs(2, "bshd", Sq=16, Sk=24)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = pfa.fused_attention_plain(q, k, v, torch.from_numpy(b), 0.35,
                                    True, "bshd")
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jfa._attn_reference(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(b), 0.35, layout="bshd", causal=True))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_cpu_tensor_routes_to_plain(monkeypatch):
    def _no_launch(*a, **k):
        raise AssertionError("the CUDA kernel was launched for CPU input")

    monkeypatch.setattr(pfa, "_launch", _no_launch)
    q, k, v, b = (torch.from_numpy(a)
                  for a in _inputs(3, "bshd", Sq=12, Sk=16))
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, 0.25, True, "bshd",
                                           return_lse=True)
    assert kreg.launches()["flash_attention_fwd"] == 0
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, 0.25, True,
                                             "bshd", return_lse=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert lse.shape == (2, 4, 12) and lse.dtype == torch.float32


def test_wrapper_refuses_dropout():
    q, k, v, b = (torch.from_numpy(a) for a in _inputs(4, "bshd"))
    with pytest.raises(NotImplementedError, match="dropout"):
        pfa.fused_attention_forward(q, k, v, b, 0.25, False, "bshd",
                                    dropout_prob=0.1)


@pytest.mark.parametrize("bad", ["bias_dtype", "bias_shape", "head_dim",
                                 "kv_mismatch", "dtype", "strided"])
def test_launch_checks_refuse_what_the_kernel_does_not_take(bad):
    q, k, v, b = (torch.from_numpy(a)
                  for a in _inputs(5, "bshd", D=8))
    if bad == "bias_dtype":
        b = b.double()
    elif bad == "bias_shape":
        b = b[:, :, :, :-1]
    elif bad == "head_dim":
        q, k, v = (torch.zeros(2, 16, 1, 129) for _ in range(3))
        b = None
    elif bad == "kv_mismatch":
        v = v[:, :-1].contiguous()
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = q.transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        pfa._check(q, k, v, b, "bshd")


def test_plain_reference_switch_nests():
    assert not kreg.plain_forced()
    with kreg.plain_reference():
        with kreg.plain_reference():
            assert kreg.plain_forced()
        assert kreg.plain_forced()
    assert not kreg.plain_forced()


def test_build_without_nvcc_says_so(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kreg.shutil, "which", lambda name: None)
    monkeypatch.setattr(kreg.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kreg.nvcc_path()


def test_kernel_source_exports_the_bound_symbol():
    src = (kreg.CSRC / kreg.SOURCES["flash_attention_fwd"]).read_text()
    assert 'extern "C" int pt_flash_attention_fwd(' in src
    assert "sm_90a" in " ".join(kreg.NVCC_FLAGS)
    name = kreg.library_path("flash_attention_fwd").name
    assert name.startswith("libflash_attention_fwd-")
