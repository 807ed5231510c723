"""The nn op family and `sign` in the port against the JAX package's
lowerings, and their builders.

* Every case of ops/family_cases.py's "nn" family (log_softmax,
  cross_entropy2, the losses log, huber, smooth_l1, hinge, rank,
  margin_rank, kldiv in its four reductions, bpr, the norms group_norm,
  instance_norm, lrn, l2_normalize, data_norm, and sign) through both
  packages' lowerings on the same seeded numpy inputs, and both
  `<op>_grad` lowerings (the generic vjp in each) under one random
  cotangent of every float output (test_torch_op_families._run).
  Tolerance: TOL = 1e-5 relative and absolute, float32; measured worst
  4.8e-7 (instance_norm: the reductions' order), 2.4e-7 (group_norm),
  0 for lrn, whose window the port sums in the JAX lowering's order.
* The JAX family's op types are all registered in the port, with a
  gradient op exactly where the JAX package has one.
* The builders (layers.group_norm, instance_norm, data_norm,
  log_softmax, l2_normalize, lrn, sign, dice_loss, npair_loss and the
  loss builders mse_loss, log_loss, huber_loss, kldiv_loss, smooth_l1,
  margin_rank_loss, rank_loss, hinge_loss, bpr_loss) build the JAX
  package's ProgramDesc byte for byte, and its forward from the JAX
  package's initial parameters equals the JAX forward within TOL.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

from test_torch_op_families import TOL, _run
from torch_threads import one_torch_thread  # noqa: F401

CASES = family_cases.cases()["nn"]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_nn_op_matches_jax(case):
    _run(case)


def test_nn_family_is_registered_whole():
    """Every op type of the JAX package's ops/nn.py, and sign, is
    registered in the port's ops/nn.py (ops/misc.py for sign), has a case
    above, and has a gradient op in the port exactly where it has one in
    the JAX package."""
    def family(ops, module):
        return {t for t in ops.types() if not ops.get(t).is_grad_op and
                inspect.getmodule(ops.get(t).lowering).__name__
                .endswith(module)}

    jax_types = family(JAX_OPS, "ops.nn")
    assert jax_types <= family(PT_OPS, "ops.nn")
    assert "sign" in family(PT_OPS, "ops.misc")
    covered = {c[0] for c in CASES}
    earlier = {"softmax", "cross_entropy", "softmax_with_cross_entropy",
               "sigmoid_cross_entropy_with_logits", "batch_norm",
               "layer_norm", "dropout", "add_position_encoding",
               "label_smoothed_softmax_xent"}
    assert not jax_types - covered - earlier, sorted(jax_types - covered)
    for t in covered:
        assert PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t


def _builders(fl):
    """A program of every new builder on small data vars; returns
    (main, startup, fetch vars, feed)."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup):
        img = L.data("img", [6, 3, 3], dtype="float32")
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [4], dtype="float32")
        p = L.data("p", [1], dtype="float32")
        lab = L.data("lab", [1], dtype="float32")
        ids = L.data("ids", [1], dtype="int64")
        outs = [
            L.group_norm(img, groups=3, act="relu"),
            L.instance_norm(img),
            L.data_norm(x),
            L.log_softmax(x),
            L.l2_normalize(x, axis=1),
            L.lrn(img, n=3, alpha=1e-2),
            L.sign(x),
            L.dice_loss(L.softmax(x), ids),
            L.npair_loss(x, y, lab),
            L.mse_loss(x, y),
            L.log_loss(p, lab),
            L.huber_loss(p, lab, delta=0.8),
            L.kldiv_loss(L.log_softmax(x), L.softmax(y),
                         reduction="batchmean"),
            L.smooth_l1(x, y, sigma=1.5),
            L.margin_rank_loss(lab, p, L.scale(p, scale=0.5), margin=0.2),
            L.rank_loss(lab, p, L.scale(p, scale=-1.0)),
            L.hinge_loss(p, lab),
            L.bpr_loss(x, ids),
        ]
    rng = np.random.default_rng(11)
    feed = {"img": rng.standard_normal((2, 6, 3, 3)).astype(np.float32),
            "x": rng.standard_normal((2, 4)).astype(np.float32),
            "y": rng.standard_normal((2, 4)).astype(np.float32),
            "p": rng.uniform(0.1, 0.9, (2, 1)).astype(np.float32),
            "lab": np.array([[1.0], [0.0]], np.float32),
            "ids": np.array([[2], [0]], np.int64)}
    return main, startup, outs, feed


def test_nn_builders_match_jax():
    jmain, jstart, jouts, feed = _builders(fluid)
    pmain, pstart, pouts, _ = _builders(pt)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    jres = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
    pres = pexe.run(pmain, feed=feed, fetch_list=pouts, scope=pscope)
    for v, j, p in zip(pouts, jres, pres):
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=v.name)
