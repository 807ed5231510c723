"""The update ops with no kernel, their optimizers and weight decay in
the port against the JAX package.

* lars_momentum, adamax, decayed_adagrad, proximal_adagrad, proximal_gd,
  adadelta, rmsprop (centered and not), ftrl and lamb
  (ops/family_cases.py's "optimizer" cases): every output of the port's
  lowering equals the JAX lowering's bit for bit (0 ulp; each square
  root correctly rounded on the CPU, as XLA's is).
* LarsMomentum, Adamax, DecayedAdagrad, Adadelta, RMSProp (centered and
  not), Ftrl and Lamb minimize a small regression net (fc 8 -> 16 relu
  -> 1, square error): the main and startup ProgramDescs equal the JAX
  package's byte for byte, and STEPS steps from the JAX package's
  initial parameters on the same feeds give the JAX losses and
  persistables within RTOL / ATOL (the forward's float32 sums run in
  another order; measured worst: losses 2.1e-7 relative, persistables
  4.0e-4 relative on elements near 0, inside ATOL).
* L1Decay and L2Decay, as the optimizer's `regularization` and through
  ParamAttr(regularizer=...) (which takes precedence), build the JAX
  package's sign / scale / sum ops (the same bytes) and train as it
  does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

from test_torch_sequence import CPU, _op
from torch_threads import one_torch_thread  # noqa: F401

CASES = family_cases.cases()["optimizer"]
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6


def _exact(case):
    """The case through both lowerings, every output equal bit for bit
    (0 ulp)."""
    op_type, inputs, attrs, out_slots, _ = case
    outs = {s: [f"{s.lower()}_out{i}" for i in range(n)]
            for s, n in out_slots.items()}
    op, env = _op(op_type, inputs, outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, {}))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, {}))
    for names in outs.values():
        for n in names:
            j, p = np.asarray(jenv[n]), penv[n].numpy()
            assert p.dtype == j.dtype and p.shape == j.shape, n
            np.testing.assert_array_equal(p, j, err_msg=f"{op_type} {n}")


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_update_op_matches_jax_bit_for_bit(case):
    _exact(case)


OPTIMIZERS = {
    "lars_momentum": lambda fl: fl.optimizer.LarsMomentum(
        0.1, 0.9, lars_coeff=0.01, lars_weight_decay=0.0005),
    "adamax": lambda fl: fl.optimizer.Adamax(0.01),
    "decayed_adagrad": lambda fl: fl.optimizer.DecayedAdagrad(0.01),
    "adadelta": lambda fl: fl.optimizer.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda fl: fl.optimizer.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda fl: fl.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True),
    "ftrl": lambda fl: fl.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "lamb": lambda fl: fl.optimizer.Lamb(0.01, lamb_weight_decay=0.01),
}


def _net(fl, make_opt, w_attr=None, regularization=None):
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup):
        x = L.data("x", [8], dtype="float32")
        y = L.data("y", [1], dtype="float32")
        h = L.fc(x, 16, act="relu", param_attr=w_attr)
        loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
        opt = make_opt(fl)
        if regularization is not None:
            opt.regularization = regularization(fl)
        opt.minimize(loss)
    return main, startup, loss


def _feed(step):
    rng = np.random.default_rng(100 + step)
    return {"x": rng.standard_normal((6, 8)).astype(np.float32),
            "y": rng.standard_normal((6, 1)).astype(np.float32)}


def _persistables(prog, scope):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _against_jax(make_opt, w_attr=None, regularization=None):
    """Program bytes, then STEPS steps in both packages from the JAX
    package's initial state: losses and persistables within RTOL /
    ATOL."""
    jmain, jstart, jloss = _net(fluid, make_opt,
                                w_attr(fluid) if w_attr else None,
                                regularization)
    pmain, pstart, ploss = _net(pt, make_opt,
                                w_attr(pt) if w_attr else None,
                                regularization)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, _persistables(jmain, jscope),
                           pt.CPUPlace())
    for step in range(STEPS):
        j = jexe.run(jmain, feed=_feed(step), fetch_list=[jloss],
                     scope=jscope)[0]
        p = pexe.run(pmain, feed=_feed(step), fetch_list=[ploss],
                     scope=pscope)[0]
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=RTOL)
    jstate = _persistables(jmain, jscope)
    pstate = _persistables(pmain, pscope)
    assert set(jstate) == set(pstate)
    for n, j in jstate.items():
        np.testing.assert_allclose(pstate[n], j, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    return pmain


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    pmain = _against_jax(OPTIMIZERS[name])
    types = [op.type for op in pmain.global_block().ops]
    assert types.count(name.replace("_centered", "")) == 4


REGULARIZED = {
    "l2_global": (None, lambda fl: fl.regularizer.L2Decay(1e-2)),
    "l1_global": (None, lambda fl: fl.regularizer.L1Decay(1e-2)),
    "l2_param": (lambda fl: fl.ParamAttr(
        regularizer=fl.regularizer.L2Decay(5e-2)), None),
    "l1_param_over_l2_global": (lambda fl: fl.ParamAttr(
        regularizer=fl.regularizer.L1Decay(5e-2)),
        lambda fl: fl.regularizer.L2Decay(1e-2)),
}


@pytest.mark.parametrize("name", sorted(REGULARIZED))
def test_weight_decay_matches_jax(name):
    """The decay ops (scale, or sign and scale, then sum a parameter) and
    3 RMSProp steps equal the JAX package's."""
    w_attr, reg = REGULARIZED[name]
    pmain = _against_jax(OPTIMIZERS["rmsprop"], w_attr, reg)
    types = [op.type for op in pmain.global_block().ops]
    decayed = 4 if reg is not None else 1
    assert types.count("sign") == (decayed if "l1_global" in name else
                                   1 if "l1" in name else 0)
    assert types.count("sum") >= decayed
