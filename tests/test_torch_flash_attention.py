"""The plain PyTorch versions of the CUDA flash-attention kernels (the
forward, with and without attention dropout, and the dq / dk-dv
backward) against the JAX package's flash attention, the dropout hash
mask against the JAX package's, and the wrappers' routing.

The JAX side runs its Pallas kernels _fa_forward / _fa_backward in
interpret mode (as tests/test_flash_attention_bwd.py does) and its
composed _attn_reference. Dropout cases hand both sides the same two
uint32 seed words. Tolerance: float32 1e-5 relative and absolute
(float32 sums in another order); bf16 inputs 2e-2 against the float32
reference on the same bf16-rounded inputs (p and out round to bf16).
The keep mask must agree bit for bit.

The kernels themselves are held against the plain versions on the card
in tests/test_torch_cuda.py and chip_smoke.py.
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
    """Keep thresholds the kernels do not realize are refused: t >= 256
    means no dropout (the caller passes None), t <= 0 drops everything
    (the caller emits zeros)."""
    q, k, v, b = (torch.from_numpy(a) for a in _inputs(4, "bshd"))
    for t in (0, 256, -3):
        with pytest.raises(ValueError, match="dropout"):
            pfa.fused_attention_forward(q, k, v, b, 0.25, False, "bshd",
                                        dropout=(1, 2, t))


_SEEDS = [(0, 0), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 7)]


@pytest.mark.parametrize("s0,s1", _SEEDS)
@pytest.mark.parametrize("B,H,Sq,Sk,t", [(2, 4, 16, 16, 230),
                                         (1, 3, 12, 40, 128),
                                         (3, 2, 33, 7, 1),
                                         (2, 2, 9, 9, 255)])
def test_dropout_keep_mask_is_the_jax_mask_bit_for_bit(s0, s1, B, H, Sq, Sk,
                                                       t):
    seed = jnp.asarray(np.array([s0, s1], np.uint32).view(np.int32))
    want = np.asarray(jfa.dropout_keep_mask(seed, B, H, Sq, Sk, t))
    got = pfa.dropout_keep_mask(s0, s1, B, H, Sq, Sk, t,
                                 device="cpu").numpy()
    assert got.dtype == np.bool_ and got.shape == (B, H, Sq, Sk)
    np.testing.assert_array_equal(got, want)
    if 1 < t < 255:
        assert 0 < got.mean() < 1


def _jax_drop(dropout):
    if dropout is None:
        return None
    s0, s1, t = dropout
    return jnp.asarray(np.array([s0, s1], np.uint32)), t


_DROPS = [None, (0x12345678, 0x9ABCDEF0, 230), (5, 9, 128)]
_DROP_IDS = ["nodrop", "t230", "t128"]


@pytest.mark.parametrize("dropout", _DROPS[1:], ids=_DROP_IDS[1:])
@pytest.mark.parametrize("layout,Sq,Sk,bias,causal,pad_all", _CASES,
                         ids=_IDS)
def test_plain_dropout_forward_matches_jax_kernel_interpret(
        layout, Sq, Sk, bias, causal, pad_all, dropout, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _inputs(6, layout, Sq=Sq, Sk=Sk, bias=bias,
                         pad_all_row=pad_all)
    scale = 8 ** -0.5
    jo, jl = jfa._fa_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), scale, Sq, Sk,
        return_lse=True, layout=layout, causal=causal,
        dropout=_jax_drop(dropout))
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    po, pl = pfa.fused_attention_plain(tt(q), tt(k), tt(v), tt(b), scale,
                                       causal, layout, return_lse=True,
                                       dropout=dropout)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dropout", _DROPS, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,Sq,Sk,bias,causal,pad_all", _CASES,
                         ids=_IDS)
def test_plain_backward_matches_jax_backward_interpret(
        layout, Sq, Sk, bias, causal, pad_all, dropout, monkeypatch):
    """dq, dk, dv (and dbias for a per-head bias) of the plain backward
    against JAX _fa_backward in interpret mode, both from the JAX
    forward's out and lse."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _inputs(7, layout, Sq=Sq, Sk=Sk, bias=bias,
                         pad_all_row=pad_all)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(
        np.float32)
    scale = 8 ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v)] + \
        [None if b is None else jnp.asarray(b)]
    jd = _jax_drop(dropout)
    out, lse = jfa._fa_forward(*jargs, scale, Sq, Sk, return_lse=True,
                               layout=layout, causal=causal, dropout=jd)
    want_dbias = bias == "per_head"
    want = jfa._fa_backward(*jargs, out, lse, jnp.asarray(g), scale, Sq,
                            Sk, layout=layout, want_dbias=want_dbias,
                            causal=causal, dropout=jd)
    tt = (lambda a: None if a is None else torch.from_numpy(np.array(a)))
    got = pfa.fused_attention_backward(
        tt(q), tt(k), tt(v), tt(b), tt(out), tt(lse), tt(g), scale, causal,
        layout, dropout=dropout, want_dbias=want_dbias)
    names = ("dq", "dk", "dv", "dbias")
    for name, pg, jg in zip(names, got, list(want) + [None] * 4):
        if not want_dbias and name == "dbias":
            assert pg is None
            continue
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_cpu_backward_routes_to_plain(monkeypatch):
    def _no_launch(*a, **k):
        raise AssertionError("a CUDA kernel was launched for CPU input")

    monkeypatch.setattr(pfa, "_launch_bwd", _no_launch)
    q, k, v, b = (torch.from_numpy(a)
                  for a in _inputs(9, "bshd", Sq=12, Sk=16))
    out, lse = pfa.fused_attention_forward(q, k, v, b, 0.25, True, "bshd",
                                           return_lse=True)
    kreg.reset_counts()
    got = pfa.fused_attention_backward(q, k, v, b, out, lse,
                                       torch.ones_like(q), 0.25, True,
                                       "bshd")
    assert kreg.launches()["flash_attention_bwd_dq"] == 0
    assert kreg.launches()["flash_attention_bwd_dkv"] == 0
    assert got[3] is None and got[0].shape == q.shape


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
        q, k, v = (torch.zeros(2, 16, 1, 0) for _ in range(3))
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


_SYMBOLS = {"flash_attention_fwd": "pt_flash_attention_fwd",
            "flash_attention_bwd_dq": "pt_flash_attention_bwd_dq",
            "flash_attention_bwd_dkv": "pt_flash_attention_bwd_dkv",
            "fused_adam": "pt_fused_adam_multi"}


@pytest.mark.parametrize("kernel", sorted(_SYMBOLS))
def test_kernel_source_exports_the_bound_symbol(kernel):
    src = (kreg.CSRC / kreg.SOURCES[kernel]).read_text()
    assert f'extern "C" int {_SYMBOLS[kernel]}(' in src
    assert "sm_90a" in " ".join(kreg.NVCC_FLAGS)
    name = kreg.library_path(kernel).name
    assert name.startswith("lib" + kreg.SOURCES[kernel][:-3] + "-")
