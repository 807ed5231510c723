"""The recurrent ops of the port (paddle_tpu_torch/ops/rnn.py) against
the JAX package's lowerings (paddle_tpu/ops/rnn.py).

lstm with peepholes on and off, forward and is_reverse, with and without
H0/C0, and other activations; gru in both origin modes, forward and
reversed, with and without H0; lstm_unit and gru_unit. Same numpy
inputs and LoD (one sequence of length 0), forward outputs and the
gradients of every input that has one (under a cotangent on each float
output) within TOL = 1e-5: the same float32 products and activations,
summed in another order (the port adds the bias before h_prev @ W, in
one addmm).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS

from test_torch_ops import _Op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CPU = torch.device("cpu")
LOD = [[0, 3, 3, 7, 8]]       # four sequences: 3, 0, 4, 1 rows
T, N, D = 8, 4, 5


def _f32(rng, *shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _view(op_type, inputs, outputs, attrs):
    op = _Op(op_type, {}, [], attrs)
    op._inputs = {s: [s.lower()] for s in inputs}
    op._outputs = {s: [n] for s, n in outputs.items()}
    return op


def _run(op_type, op, values, lods):
    jenv = {n: jnp.asarray(a) for n, a in values.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in values.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None,
                                             dict(lods)))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, dict(lods)))
    return jenv, penv


def _close(j, p, msg):
    j, p = np.asarray(j), p.detach().numpy()
    assert j.shape == p.shape, (msg, j.shape, p.shape)
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=msg)


def _check(op_type, inputs, outs, grads_of, attrs, lods, aux=()):
    """Forward outputs `outs` (slots) and the gradients of `grads_of`
    (input slots) under one cotangent on each output in `outs`; `aux`
    output slots are bound but neither compared nor differentiated."""
    names = {s: s.lower() + "_out" for s in list(outs) + list(aux)}
    op = _view(op_type, inputs, names, attrs)
    values = {s.lower(): a for s, a in inputs.items()}
    jenv, penv = _run(op_type, op, values, lods)
    for s in outs:
        _close(jenv[names[s]], penv[names[s]], f"{op_type}.{s}")
    rng = np.random.default_rng(99)
    g_in = dict(inputs)
    for s in list(outs) + list(aux):
        g_in[s] = np.asarray(jenv[names[s]])
        g_in[s + "@GRAD"] = _f32(rng, *g_in[s].shape, scale=1.0) \
            if s in outs else None
    gop = _Op(op_type + "_grad", {}, [], attrs)
    gop._inputs = {s: ([s.lower()] if v is not None else [""])
                   for s, v in g_in.items()}
    gop._outputs = {s + "@GRAD": [s.lower() + "@g"] for s in grads_of}
    gvalues = {s.lower(): v for s, v in g_in.items() if v is not None}
    jenv, penv = _run(op_type + "_grad", gop, gvalues, lods)
    for s in grads_of:
        n = s.lower() + "@g"
        _close(jenv[n], penv[n], f"{op_type} d{s}")


def _lstm_inputs(peep, init, seed=0):
    r = np.random.default_rng(seed)
    inputs = {"Input": _f32(r, T, 4 * D), "Weight": _f32(r, D, 4 * D),
              "Bias": _f32(r, 1, (7 if peep else 4) * D)}
    if init:
        inputs["H0"] = _f32(r, N, D)
        inputs["C0"] = _f32(r, N, D)
    return inputs


@pytest.mark.parametrize("peep", [True, False], ids=["peep", "nopeep"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0c0"])
def test_lstm_matches_jax(peep, reverse, init):
    inputs = _lstm_inputs(peep, init)
    grads = ["Input", "Weight", "Bias"] + (["H0"] if init else [])
    _check("lstm", inputs, ["Hidden", "Cell"], grads,
           {"use_peepholes": peep, "is_reverse": reverse,
            "gate_activation": "sigmoid", "cell_activation": "tanh",
            "candidate_activation": "tanh"},
           {"input": LOD}, aux=["BatchGate", "BatchCellPreAct"])


def test_lstm_other_activations_match_jax():
    _check("lstm", _lstm_inputs(True, True, seed=1), ["Hidden", "Cell"],
           ["Input", "Weight", "Bias", "H0"],
           {"use_peepholes": True, "is_reverse": True,
            "gate_activation": "sigmoid", "cell_activation": "relu",
            "candidate_activation": "identity"}, {"input": LOD})


@pytest.mark.parametrize("origin", [False, True], ids=["default",
                                                       "origin"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0"])
def test_gru_matches_jax(origin, reverse, init):
    r = np.random.default_rng(2)
    inputs = {"Input": _f32(r, T, 3 * D), "Weight": _f32(r, D, 3 * D),
              "Bias": _f32(r, 1, 3 * D)}
    if init:
        inputs["H0"] = _f32(r, N, D)
    _check("gru", inputs, ["Hidden"], ["Input", "Weight", "Bias"],
           {"is_reverse": reverse, "origin_mode": origin,
            "gate_activation": "sigmoid", "activation": "tanh"},
           {"input": LOD},
           aux=["BatchGate", "BatchResetHiddenPrev", "BatchHidden"])


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_jax(forget_bias):
    r = np.random.default_rng(3)
    _check("lstm_unit", {"X": _f32(r, N, 4 * D), "C_prev": _f32(r, N, D)},
           ["C", "H"], ["X", "C_prev"], {"forget_bias": forget_bias}, {})


@pytest.mark.parametrize("origin", [False, True], ids=["default",
                                                       "origin"])
@pytest.mark.parametrize("acts", [(1, 2), (0, 3)], ids=["sig-tanh",
                                                        "id-relu"])
def test_gru_unit_matches_jax(origin, acts):
    r = np.random.default_rng(4)
    _check("gru_unit", {"Input": _f32(r, N, 3 * D),
                        "HiddenPrev": _f32(r, N, D),
                        "Weight": _f32(r, D, 3 * D),
                        "Bias": _f32(r, 1, 3 * D)},
           ["Gate", "ResetHiddenPrev", "Hidden"],
           ["Input", "HiddenPrev", "Weight", "Bias"],
           {"origin_mode": origin, "gate_activation": acts[0],
            "activation": acts[1]}, {})
