"""SGD as one multi-tensor update, against the JAX package.

* The list entry's plain version (fused_sgd_multi on CPU tensors) over
  LeNet's six parameter shapes and odd lengths: without weight decay 0
  ulp from the JAX lowered sgd, and with or without it within the
  roundings the JAX fused_sgd Pallas kernel (interpret mode) takes
  otherwise: XLA on the CPU contracts a multiply and an add into one
  fused multiply-add, while the port rounds each operation (the
  contract of test_torch_lenet.test_sgd_op_matches_jax_lowered_sgd,
  plus, with weight decay, the roundings of wd*p and g + wd*p carried
  through lr).
* The engine's grouping: a run of sgd ops that share a LearningRate
  goes to one call of the kernel's list entry. Three LeNet steps at
  PT_KERNEL_MIN_NUMEL=1 with the CPU routing hook armed give the same
  bits grouped as op by op, and match the JAX package's three steps
  within 1e-5; the registry still counts one decision per op.
* Which ops a group takes: same type, same key, no op reading what an
  earlier one of the run wrote.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.kernels import fused_optimizer as jfo
from paddle_tpu.models import lenet as jax_lenet

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import fused_optimizer as pfo
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import lenet as pt_lenet

from test_torch_lenet import _batch, _build
from test_torch_ops import _run_both
from test_torch_training import _ulps
from torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
LR, STEPS = 0.05, 3
# LeNet's parameters and lengths that cut float4 runs and 4096-element
# chunks
_SHAPES = [(20, 1, 5, 5), (20,), (50, 20, 5, 5), (50,), (800, 10), (10,),
           (1,), (127,), (129,), (513,), (4097,)]


@pytest.fixture(autouse=True)
def _clean_registry():
    kreg.reset_stats()
    yield
    kreg.reset_stats()


def _lists(seed):
    r = np.random.default_rng(seed)
    ps = [r.standard_normal(sh).astype(np.float32) for sh in _SHAPES]
    gs = [r.standard_normal(sh).astype(np.float32) for sh in _SHAPES]
    return ps, gs


@pytest.mark.parametrize("wd", [0.0, 1e-4, 0.01])
def test_sgd_list_plain_matches_jax(wd):
    ps, gs = _lists(int(wd * 1e4))
    lr = np.float32(LR)
    kreg.reset_counts()
    got = pfo.fused_sgd_multi([torch.from_numpy(p) for p in ps],
                              [torch.from_numpy(g) for g in gs],
                              torch.tensor([lr]), weight_decay=wd)
    assert not any(kreg.launches().values())      # CPU: the plain version
    assert len(got) == len(ps)
    for p, g, out in zip(ps, gs, got):
        out = out.numpy()
        assert out.shape == p.shape and out.dtype == np.float32
        if not wd:
            (j, _), = _run_both("sgd", {
                "Param": p, "Grad": g,
                "LearningRate": np.array([lr], np.float32)},
                ["ParamOut"], {}).values()
            assert _ulps(out, j).max() == 0
        want = np.asarray(jfo.fused_sgd(jnp.asarray(p), jnp.asarray(g),
                                        jnp.asarray(lr), weight_decay=wd))
        g_eff = g + np.float32(wd) * p if wd else g
        bound = np.spacing(np.abs(lr * g_eff)) + np.spacing(np.abs(want))
        if wd:
            bound = bound + lr * (np.spacing(np.abs(np.float32(wd) * p))
                                  + np.spacing(np.abs(g_eff)))
        assert np.all(np.abs(out - want) <= bound)


def test_sgd_list_entry_checks_its_lists():
    p = torch.zeros(3)
    lr = torch.tensor([LR])
    assert pfo.fused_sgd_multi([], [], lr) == []
    with pytest.raises(ValueError, match="parameters"):
        pfo.fused_sgd_multi([p, p], [p], lr)
    # a list of one is the single-tensor entry
    out = pfo.fused_sgd(torch.ones(5), torch.ones(5), lr)
    assert torch.equal(out, torch.full((5,), 1 - LR))
    assert kreg.get("fused_sgd").run_many is pfo.fused_sgd_multi


def _steps(monkeypatch, grouped):
    """STEPS LeNet steps through the port's Executor at floor 1 with the
    CPU routing hook armed: losses, parameters, the calls into the SGD
    kernel's two entries and the registry's decisions of each step."""
    monkeypatch.setattr(kreg, "_ROUTE_ON_CPU", True)
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    monkeypatch.delenv("PT_KERNEL_DENY", raising=False)
    if not grouped:
        monkeypatch.setattr(PT_OPS.get("sgd"), "group", None)
    kern = kreg.get("fused_sgd")
    calls = {"run": 0, "run_many": []}

    def run(*a, _run=kern.run, **kw):
        calls["run"] += 1
        return _run(*a, **kw)

    def run_many(ps, *a, _run=kern.run_many, **kw):
        calls["run_many"].append(len(ps))
        return _run(ps, *a, **kw)
    monkeypatch.setattr(kern, "run", run)
    monkeypatch.setattr(kern, "run_many", run_many)

    jmain, jstartup, _, _, _ = _build(fluid, jax_lenet)
    pmain, _, _, pcost, _ = _build(pt, pt_lenet)
    jscope, pscope = JaxScope(), pt.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=jscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None]
    load_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n).get_tensor())
                 for n in names}, pt.CPUPlace())
    exe, feed = pt.Executor(pt.CPUPlace()), _batch()
    losses, decisions = [], []
    for _ in range(STEPS):
        kreg.reset_stats()
        losses.append(exe.run(pmain, feed=feed, fetch_list=[pcost],
                              scope=pscope)[0])
        decisions.append(kreg.dispatch_stats()["per_kernel"]["fused_sgd"])
    params = {n: np.asarray(pscope.find_var(n).get_tensor()) for n in names}
    monkeypatch.undo()
    return losses, params, calls, decisions


def test_grouped_lenet_steps_equal_per_op_steps_and_jax(monkeypatch):
    grouped = _steps(monkeypatch, True)
    per_op = _steps(monkeypatch, False)
    # one call of the list entry a step, with the six parameters
    assert grouped[2] == {"run": 0, "run_many": [6] * STEPS}
    assert per_op[2] == {"run": 6 * STEPS, "run_many": []}
    # the registry decides and counts op by op either way
    for dec in grouped[3] + per_op[3]:
        assert dec == {"custom": 6}
    for a, b in zip(grouped[0], per_op[0]):
        assert np.array_equal(a, b)
    for n, v in grouped[1].items():
        assert np.array_equal(v, per_op[1][n]), n

    # against the JAX package's three steps from the same parameters
    jmain, jstartup, _, jcost, _ = _build(fluid, jax_lenet)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    for step in range(STEPS):
        jl, = jexe.run(jmain, feed=_batch(), fetch_list=[jcost],
                       scope=jscope)
        np.testing.assert_allclose(grouped[0][step], np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
    for n, v in grouped[1].items():
        np.testing.assert_allclose(v, np.asarray(
            jscope.find_var(n).get_tensor()), rtol=RTOL, atol=ATOL,
            err_msg=n)


class _FakeOp:
    def __init__(self, type, lr, reads, writes, uid):
        self.type = type
        self._lr = [lr]
        self.input_arg_names = list(reads) + [lr]
        self.output_arg_names = list(writes)
        self._uid = uid

    def input(self, slot):
        return self._lr if slot == "LearningRate" else []

    def attr(self, name):
        return self._uid


def test_a_group_stops_at_another_type_key_or_a_dependency():
    key = PT_OPS.get("sgd").group[0]
    ops = [_FakeOp("sgd", "lr0", ["p0", "g0"], ["p0"], 1),
           _FakeOp("sgd", "lr0", ["p1", "g1"], ["p1"], 2),
           _FakeOp("sgd", "lr1", ["p2", "g2"], ["p2"], 3),    # other rate
           _FakeOp("sgd", "lr1", ["p3", "g3"], ["p3"], 4),
           _FakeOp("sgd", "lr1", ["p3", "g4"], ["p3"], 5),    # reads p3
           _FakeOp("mean", "lr1", ["x"], ["y"], 6),
           _FakeOp("sgd", "lr1", ["p5", "g5"], ["p5"], 7)]
    ends, i = [], 0
    while i < len(ops):
        i = engine._group_end(ops, i, key, {}) if ops[i].type == "sgd" \
            else i + 1
        ends.append(i)
    assert ends == [2, 4, 5, 6, 7]
    # an op whose forward record the run needs is never grouped
    assert engine._group_end(ops, 0, key, {2: frozenset()}) == 1
