"""Head dims above 256: the plain versions the CUDA-core kernels are
held to on the card (where D > 256 runs in 256-column groups of the
output), against the JAX package.

* D = 320 (D % 8 == 0): the JAX package runs its Pallas kernels,
  _fa_forward / _fa_backward in interpret mode; forward (out, lse) and
  backward (dq, dk, dv, dbias) from the JAX forward's out and lse.
* D = 260 (D % 8 != 0): the JAX package takes its composed path, as its
  flash_attention does for such a D (_kernel_ok): _attn_reference_lse
  forward, the vector-Jacobian product of flash_attention's composed
  formulation backward.
Both layouts, causal or not, a key-padding or a per-head bias.
Tolerance 1e-5 relative and absolute (float32 sums in another order), as
the port's other attention tests.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import registry as jkreg
from paddle_tpu_torch.kernels import flash_attention as pfa

from test_torch_faults import _wide_inputs
from torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL = ATOL = 1e-5

_CASES = [
    # (layout, B, H, Sq, Sk, bias, causal)
    ("bshd", 2, 2, 16, 12, "key_pad", True),
    ("bhsd", 1, 2, 12, 16, "per_head", False),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_port(q, k, v, b, g, scale, layout, causal, jo, jl, jgrads):
    """The port's plain forward against (jo, jl), its plain backward from
    the JAX forward's out and lse against jgrads (dq, dk, dv, dbias)."""
    po, pl = pfa.fused_attention_forward(_t(q), _t(k), _t(v), _t(b), scale,
                                         causal, layout, return_lse=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    got = pfa.fused_attention_backward(_t(q), _t(k), _t(v), _t(b), _t(jo),
                                       _t(jl), _t(g), scale, causal, layout,
                                       want_dbias=True)
    for name, pg, jg in zip(("dq", "dk", "dv", "dbias"), got, jgrads):
        assert pg.shape == tuple(jg.shape), name
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("layout,B,H,Sq,Sk,bias,causal", _CASES)
def test_head_dim_320_matches_jax_kernels_interpret(layout, B, H, Sq, Sk,
                                                    bias, causal,
                                                    monkeypatch):
    D = 320
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _wide_inputs(D + Sq, layout, B, H, Sq, Sk, D, bias)
    g = np.random.default_rng(D).standard_normal(q.shape).astype(np.float32)
    scale = D ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, b)]
    jo, jl = jfa._fa_forward(*jargs, scale, Sq, Sk, return_lse=True,
                             layout=layout, causal=causal)
    jgrads = jfa._fa_backward(*jargs, jo, jl, jnp.asarray(g), scale, Sq, Sk,
                              layout=layout, want_dbias=True, causal=causal)
    _check_port(q, k, v, b, g, scale, layout, causal, jo, jl, jgrads)


@pytest.mark.parametrize("layout,B,H,Sq,Sk,bias,causal", _CASES)
def test_head_dim_260_matches_jax_composed_path(layout, B, H, Sq, Sk, bias,
                                                causal):
    D = 260
    q, k, v, b = _wide_inputs(D + Sq, layout, B, H, Sq, Sk, D, bias)
    g = np.random.default_rng(D).standard_normal(q.shape).astype(np.float32)
    scale = D ** -0.5
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, b))
    assert not jfa._kernel_ok(jq, jk, 128, 128, layout)
    # the composed forward with lse ([B, H, S, D] only)
    move = (lambda x: jnp.moveaxis(x, 2, 1)) if layout == "bshd" \
        else (lambda x: x)
    jo, jl = jfa._attn_reference_lse(move(jq), move(jk), move(jv), jb, scale,
                                     causal=causal)
    jo = move(jo)
    jkreg.reset_stats()
    try:
        _, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, scale, 128, 128, layout, causal, True), jq, jk, jv, jb)
        jgrads = vjp(jnp.asarray(g))
        assert jkreg.dispatch_stats()["per_kernel"]["flash_attention"] == \
            {"lowered": 1}
    finally:
        jkreg.reset_stats()
    _check_port(q, k, v, b, g, scale, layout, causal, jo, jl, jgrads)
