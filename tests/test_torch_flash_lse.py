"""flash_attention_lse (kernels/flash_attention.py) in the port against the
JAX package: (out, lse) on [B, H, S, D] with cotangents on both outputs.

* Forward: out and lse against the JAX flash_attention_lse with its
  Pallas kernel in interpret mode, within RTOL / ATOL.
* Backward: the gradients of q, k, v (and bias) under random cotangents of
  out and lse against jax.vjp of the JAX flash_attention_lse (its kernel
  path, _fa_backward with g_lse) and against float64 exact gradients of
  the composed (out, lse), within RTOL / ATOL.
* g_lse = 0 gives fused_attention_backward's gradients bit for bit; no
  lse cotangent at all is the same.
* bf16: the plain backward with a random g_lse meets bf16_backward_bound
  extended for the g_lse term (step 3 of its derivation), also on rows
  where di - g_lse cancels; a ds that drops the term does not.
* CPU tensors never reach a kernel.

Tolerance: RTOL = ATOL = 1e-5 in float32 (the order of float32 sums
differs); bf16 as bf16_backward_bound says.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.kernels import flash_attention as pfa
from torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL = ATOL = 1e-5
SCALE = 8 ** -0.5


def _inputs(seed, B=2, H=2, Sq=16, Sk=16, D=8, bias=True, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(dtype)
    k = rng.standard_normal((B, H, Sk, D)).astype(dtype)
    v = rng.standard_normal((B, H, Sk, D)).astype(dtype)
    b = None
    if bias:
        lens = np.array([Sk, Sk - 5])[:B]
        b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                     -1e9).astype(np.float32)[:, None, None, :]
    g_out = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, Sq)).astype(np.float32)
    return q, k, v, b, g_out, g_lse


def _jax(q, k, v, b, g_out, g_lse, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)

    def f(q, k, v):
        return jfa.flash_attention_lse(q, k, v,
                                       None if b is None else jnp.asarray(b),
                                       SCALE, 8, 8)
    (out, lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    return [np.asarray(x) for x in (out, lse) + tuple(grads)]


def _port(q, k, v, b, g_out, g_lse, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    bt = None if b is None else torch.from_numpy(b)
    out, lse = pfa.flash_attention_lse(qt, kt, vt, bt, SCALE)
    outs, cts = [out], [torch.from_numpy(g_out).to(out.dtype)]
    if g_lse is not None:
        outs.append(lse)
        cts.append(torch.from_numpy(g_lse))
    torch.autograd.backward(outs, cts)
    return out, lse, qt.grad, kt.grad, vt.grad


def _exact(q, k, v, b, g_out, g_lse):
    """float64 gradients of the composed (out, lse)."""
    qd, kd, vd = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    s = qd @ kd.transpose(-1, -2) * SCALE
    if b is not None:
        s = s + torch.from_numpy(b).double()
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ vd
    torch.autograd.backward([out, lse], [torch.from_numpy(g_out).double(),
                                         torch.from_numpy(g_lse).double()])
    return qd.grad, kd.grad, vd.grad


_CASES = [dict(), dict(bias=False), dict(Sq=8, Sk=16), dict(D=16, H=3)]


@pytest.mark.parametrize("case", _CASES, ids=str)
def test_matches_jax_flash_attention_lse(case, monkeypatch):
    ins = _inputs(1, **case)
    want = _jax(*ins, monkeypatch)
    got = _port(*ins)
    for name, a, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name, a, e in zip(("dq", "dk", "dv"), got[2:], _exact(*ins)):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_bias_gradient_matches_exact():
    q, k, v, b, g_out, g_lse = _inputs(2)
    b = b + np.random.default_rng(5).standard_normal(b.shape).astype(
        np.float32) * (b == 0)
    bt = torch.from_numpy(b).requires_grad_()
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = pfa.flash_attention_lse(qt, kt, vt, bt, SCALE)
    torch.autograd.backward([out, lse], [torch.from_numpy(g_out),
                                         torch.from_numpy(g_lse)])
    bd = torch.from_numpy(b).double().requires_grad_()
    s = torch.from_numpy(q).double() @ torch.from_numpy(k).double() \
        .transpose(-1, -2) * SCALE + bd
    torch.autograd.backward(
        [torch.softmax(s, -1) @ torch.from_numpy(v).double(),
         torch.logsumexp(s, -1)],
        [torch.from_numpy(g_out).double(), torch.from_numpy(g_lse).double()])
    np.testing.assert_allclose(bt.grad.numpy(), bd.grad.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("g_lse", ["zero", "none"])
def test_zero_lse_cotangent_is_fused_attention_backward(g_lse):
    q, k, v, b, g_out, _ = _inputs(3)
    got = _port(q, k, v, b, g_out,
                np.zeros(q.shape[:3], np.float32) if g_lse == "zero"
                else None)
    qt, kt, vt, bt = (torch.from_numpy(a) for a in (q, k, v, b))
    out, lse = pfa.fused_attention_forward(qt, kt, vt, bt, SCALE, False,
                                           "bhsd", return_lse=True)
    want = pfa.fused_attention_backward(qt, kt, vt, bt, out, lse,
                                        torch.from_numpy(g_out), SCALE,
                                        False, "bhsd")
    for a, w in zip(got[2:], want[:3]):
        assert torch.equal(a, w)


def _bf16_case(seed, cancel):
    """bf16 inputs and a g_lse; with `cancel`, g_lse = di on half the
    rows, so that di - g_lse cancels there."""
    q, k, v, b, g_out, g_lse = _inputs(seed, B=2, H=2, Sq=32, Sk=32, D=16)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g_out)]
    bt = torch.from_numpy(b)
    out, lse = pfa.fused_attention_forward(*bf[:3], bt, SCALE, False,
                                           "bhsd", return_lse=True)
    gl = torch.from_numpy(g_lse)
    if cancel:
        di = (bf[3].float() * out.float()).sum(-1)
        gl = torch.where(torch.arange(32)[None, None] % 2 == 0, di, gl)
    return bf, bt, out, lse, gl


@pytest.mark.parametrize("cancel", [False, True])
def test_bf16_backward_meets_the_extended_bound(cancel):
    (q, k, v, g), b, out, lse, gl = _bf16_case(7, cancel)
    got = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, g, SCALE,
                                             False, "bhsd", g_lse=gl)
    exact, bound = pfa.bf16_backward_bound(q, k, v, b, out, lse, g, SCALE,
                                           False, "bhsd", g_lse=gl)
    for name, a, e, w in zip(("dq", "dk", "dv"), got, exact, bound):
        err = (a.double() - e).abs()
        assert bool((err <= w).all()), (name, float((err - w).max()))
    # a backward that leaves g_lse out of ds misses it
    wrong = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, g,
                                               SCALE, False, "bhsd")
    assert not bool(((wrong[0].double() - exact[0]).abs()
                     <= bound[0]).all())


def test_cpu_tensors_never_launch(monkeypatch):
    def _no_launch(*a, **k):
        raise AssertionError("a CUDA kernel was launched for CPU input")

    monkeypatch.setattr(pfa, "_launch", _no_launch)
    monkeypatch.setattr(pfa, "_launch_bwd", _no_launch)
    got = _port(*_inputs(4))
    assert all(torch.isfinite(t).all() for t in got)
