"""The basic, reduce, elementwise and activation op families in the port
against the JAX package's lowerings, one parametrised test a family and
one case (or more) an op type (the cases: paddle_tpu_torch/ops/
family_cases.py, which chip_smoke.py's op sweep runs on the card).

Each case feeds the same seeded numpy inputs to both packages' lowering
and compares every output; where the op has a gradient, both packages'
`<op>_grad` lowerings (the generic vjp in each) run under one random
cotangent on every float output, and the gradients of the inputs in
`diff` are compared. The last test holds the port's registry to the JAX
package's for these four families: every op type registered, with the
same gradient / no-gradient split.

Tolerance: float results within TOL = 1e-5 relative and absolute (the
order of float32 sums and the libm of each framework differ); integer
and bool results exact, the port's int64 compared to the JAX package's
int32 where it writes int32 for want of 64-bit types (arg_max, arg_min,
argsort's indices, size, cumsum and range on int64 inputs). Inputs stay
away from the points where a function or its derivative jumps (clip and
relu6 bounds, floor and round steps, ties of max and min), where the two
frameworks may pick different one-sided values.
"""
import inspect

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
from paddle_tpu_torch.ops import family_cases

from test_torch_sequence import CPU, _names, _op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
FAMILIES = ("basic", "reduce", "elementwise", "activations")


def _check(j, p, msg):
    j, p = np.asarray(j), p.detach().numpy()
    assert j.shape == p.shape, (msg, j.shape, p.shape)
    if np.issubdtype(j.dtype, np.floating):
        assert p.dtype == j.dtype, (msg, p.dtype, j.dtype)
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=msg)
    else:
        if j.dtype == np.int32 and p.dtype == np.int64:
            pass   # the JAX package's int32 for the reference's int64
        else:
            assert p.dtype == j.dtype, (msg, p.dtype, j.dtype)
        np.testing.assert_array_equal(p.astype(np.int64),
                                      j.astype(np.int64), err_msg=msg)


def _run(case):
    op_type, inputs, attrs, out_slots, diff = case
    outs = {s: [f"{s.lower()}_out{i}" for i in range(n)]
            for s, n in out_slots.items()}
    op, env = _op(op_type, inputs, outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, {}))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, {}))
    for names in outs.values():
        for n in names:
            _check(jenv[n], penv[n], f"{op_type} {n}")
    if diff:
        _grads(op_type, inputs, attrs, outs, jenv, diff)


def _grads(op_type, inputs, attrs, outs, jenv, diff):
    """Both `<op>_grad` lowerings under one cotangent of every float
    output; the gradients of `diff` compared."""
    rng = np.random.default_rng(7)
    g_in = dict(inputs)
    names = {}
    for s, ns in outs.items():
        vals = [np.asarray(jenv[n]) for n in ns]
        if not np.issubdtype(vals[0].dtype, np.floating):
            continue
        g_in[s] = vals if len(vals) > 1 else vals[0]
        g_in[s + "@GRAD"] = [rng.standard_normal(v.shape).astype(v.dtype)
                             for v in vals] if len(vals) > 1 else \
            rng.standard_normal(vals[0].shape).astype(vals[0].dtype)
        names[s] = ns
    g_outs = {s + "@GRAD": [n + "@g" for n in _names(s, inputs[s])]
              for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    jg = {n: jnp.asarray(a) for n, a in env.items()}
    pg = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get(op_type + "_grad").lowering(JaxContext(op, jg, None, None,
                                                       {}))
    PT_OPS.get(op_type + "_grad").lowering(PtContext(op, pg, CPU, None, {}))
    for ns in g_outs.values():
        for n in ns:
            _check(jg[n], pg[n], f"{op_type} {n}")


CASES = family_cases.cases()


def _ids(family):
    return [f"{c[0]}-{i}" for i, c in enumerate(CASES[family])]


@pytest.mark.parametrize("case", CASES["basic"], ids=_ids("basic"))
def test_basic_op_matches_jax(case):
    _run(case)


@pytest.mark.parametrize("case", CASES["reduce"], ids=_ids("reduce"))
def test_reduce_op_matches_jax(case):
    _run(case)


@pytest.mark.parametrize("case", CASES["elementwise"],
                         ids=_ids("elementwise"))
def test_elementwise_op_matches_jax(case):
    _run(case)


@pytest.mark.parametrize("case", CASES["activations"],
                         ids=_ids("activations"))
def test_activation_op_matches_jax(case):
    _run(case)


def _family_types(ops, family):
    return {t for t in ops.types() if not ops.get(t).is_grad_op and
            inspect.getmodule(ops.get(t).lowering).__name__.endswith(
                "ops." + family)}


@pytest.mark.parametrize("family", FAMILIES)
def test_family_is_registered_whole(family):
    """Every op type of the JAX family is registered in the port's
    module of the same name, with a case above or in an earlier slice's
    file, and each with a case above has a gradient op in the port
    exactly where it has one in the JAX package."""
    jax_types = _family_types(JAX_OPS, family)
    assert jax_types <= _family_types(PT_OPS, family)
    covered = {c[0] for fam in CASES.values() for c in fam}
    held_elsewhere = {"relu", "sigmoid", "tanh", "square", "log",
                      "reduce_sum", "mean", "cos_sim", "elementwise_add",
                      "elementwise_sub", "elementwise_mul",
                      "elementwise_div", "less_than", "less_equal",
                      "greater_than", "greater_equal", "equal",
                      "not_equal", "logical_and", "logical_or",
                      "logical_xor", "logical_not"}
    missing = jax_types - covered - held_elsewhere
    if family == "basic":
        import test_torch_ops
        missing -= {c[0] for c in test_torch_ops._CASES} | {
            "gather", "stack", "top_k", "lookup_table", "sum",
            "merge_selected_rows", "get_tensor_from_selected_rows",
            "flatten", "flatten2", "concat"}
    assert not missing, sorted(missing)
    for t in jax_types & covered:
        assert PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t
