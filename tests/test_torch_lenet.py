"""LeNet on MNIST with SGD (BASELINE config 1) in the port, against the
JAX package.

* Each LeNet op (conv2d, depthwise_conv2d, pool2d, softmax,
  cross_entropy, mean, top_k, accuracy) through both packages' lowerings
  on the same numpy inputs, and the gradients of the differentiable ones
  through both packages' `<op>_grad` lowerings with the same cotangent.
  Tolerance 1e-5 relative and absolute (float32 sums in another order:
  a 5x5 conv sums 25 to 100 products); integer outputs exact.
* The sgd op 0 ulp from the JAX lowered sgd; the port's sgd_plain
  against the JAX fused_sgd Pallas kernel in interpret mode, which XLA
  computes with a fused multiply-add (bound: the roundings of lr*g and
  of the result).
* The LeNet SGD program (its 35 op types, in order) and its test clone
  against the JAX package's; 3 SGD steps from the JAX package's initial
  parameters: losses, accuracy and every parameter within 1e-5.
* The registry gates of fused_adam and fused_sgd on the CPU with the
  test hook armed: the deny list, FLAGS_use_custom_kernels and the size
  floor; the adam and sgd ops run a kernel only when the registry picks
  one, and give the same values either way.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.kernels import fused_optimizer as jfo
from paddle_tpu.models import lenet as jax_lenet

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import fused_optimizer as pfo
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import lenet as pt_lenet

from test_torch_ops import _Op, _run_both
from test_torch_training import _ulps
from torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
B, LR, STEPS = 8, 0.05, 3


@pytest.fixture(autouse=True)
def _clean_registry():
    kreg.reset_stats()
    yield
    set_flags({"FLAGS_use_custom_kernels": True})
    kreg.reset_stats()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops and their gradients
# ---------------------------------------------------------------------------

def _probs(rng, n, k):
    x = rng.random((n, k)).astype(np.float32) + 0.05
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _cases():
    r = _rng(7)
    lbl = r.integers(0, 10, (6, 1)).astype(np.int64)
    lbl[2, 0] = 3                      # rows at ignore_index give 0
    return [
        ("conv2d", {"Input": _f32(r, 2, 3, 9, 9),
                    "Filter": _f32(r, 4, 3, 5, 5)}, ["Output"],
         {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
          "groups": 1, "data_format": "NCHW"}),
        ("conv2d", {"Input": _f32(r, 2, 4, 9, 10),
                    "Filter": _f32(r, 6, 2, 3, 3)}, ["Output"],
         {"strides": [2, 1], "paddings": [1, 2], "dilations": [2, 1],
          "groups": 2, "data_format": "NCHW"}),
        ("conv2d", {"Input": _f32(r, 2, 8, 8, 3),
                    "Filter": _f32(r, 5, 3, 3, 3)}, ["Output"],
         {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1, "data_format": "NHWC"}),
        ("depthwise_conv2d", {"Input": _f32(r, 2, 3, 8, 8),
                              "Filter": _f32(r, 3, 1, 3, 3)}, ["Output"],
         {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 3, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 3, 8, 8)}, ["Out"],
         {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
          "paddings": [0, 0], "global_pooling": False, "ceil_mode": False,
          "exclusive": True, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 3, 9, 9)}, ["Out"],
         {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
          "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
          "exclusive": True, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 3, 9, 9)}, ["Out"],
         {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
          "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
          "exclusive": False, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 3, 8, 8)}, ["Out"],
         {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
          "paddings": [0, 0], "global_pooling": False, "ceil_mode": True,
          "exclusive": True, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 3, 8, 8)}, ["Out"],
         {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
          "paddings": [1, 1], "global_pooling": False, "ceil_mode": True,
          "exclusive": False, "data_format": "NCHW"}),
        ("pool2d", {"X": _f32(r, 2, 5, 5, 3)}, ["Out"],
         {"pooling_type": "avg", "ksize": [2, 2], "strides": [1, 1],
          "paddings": [0, 0], "global_pooling": True, "ceil_mode": False,
          "exclusive": True, "data_format": "NHWC"}),
        ("pool2d", {"X": _f32(r, 2, 3, 5, 5)}, ["Out"],
         {"pooling_type": "max", "ksize": [2, 2], "strides": [1, 1],
          "paddings": [0, 0], "global_pooling": True, "ceil_mode": False,
          "exclusive": True, "data_format": "NCHW"}),
        ("softmax", {"X": _f32(r, 6, 10)}, ["Out"], {"axis": -1}),
        ("cross_entropy", {"X": _probs(r, 6, 10), "Label": lbl}, ["Y"],
         {"soft_label": False, "ignore_index": 3}),
        ("cross_entropy", {"X": _probs(r, 6, 10),
                           "Label": _probs(r, 6, 10)}, ["Y"],
         {"soft_label": True, "ignore_index": -100}),
        ("mean", {"X": _f32(r, 6, 7)}, ["Out"], {}),
    ]


_CASES = _cases()


@pytest.mark.parametrize("op_type,inputs,outputs,attrs", _CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_CASES)])
def test_op_matches_jax(op_type, inputs, outputs, attrs):
    for slot, (j, p) in _run_both(op_type, inputs, outputs,
                                  attrs).items():
        assert p.shape == j.shape and p.dtype == j.dtype, slot
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL, err_msg=slot)


def _grad_both(op_type, inputs, outputs, attrs, seed):
    """Each float input's gradient from both packages' `<op>_grad`
    lowerings, under the same random cotangent of every output."""
    fwd = _run_both(op_type, inputs, outputs, attrs)
    r = _rng(seed)
    cts = {s: r.standard_normal(j.shape).astype(np.float32)
           for s, (j, _) in fwd.items()}
    diff = [s for s, a in inputs.items()
            if np.issubdtype(a.dtype, np.floating) and
            s not in ("Label",)]
    vals = dict(inputs)
    for s, (j, _) in fwd.items():
        vals[s] = j
        vals[s + "@GRAD"] = cts[s]
    op = _Op(op_type + "_grad", vals, [s + "@GRAD" for s in diff], attrs)
    op._inputs = {s: [s.lower()] for s in vals}
    op._outputs = {s + "@GRAD": [s.lower() + "@grad_out"] for s in diff}
    jenv = {s.lower(): jnp.asarray(a) for s, a in vals.items()}
    JAX_OPS.get(op_type + "_grad").lowering(JaxContext(op, jenv))
    penv = {s.lower(): torch.from_numpy(np.array(a))
            for s, a in vals.items()}
    PT_OPS.get(op_type + "_grad").lowering(
        PtContext(op, penv, torch.device("cpu")))
    return {s: (np.asarray(jenv[s.lower() + "@grad_out"]),
                penv[s.lower() + "@grad_out"].numpy()) for s in diff}


_DIFF = [(i, c) for i, c in enumerate(_CASES)]


@pytest.mark.parametrize("case", _DIFF,
                         ids=[f"{c[0]}-{i}" for i, c in _DIFF])
def test_grad_matches_jax(case):
    i, (op_type, inputs, outputs, attrs) = case
    grads = _grad_both(op_type, inputs, outputs, attrs, seed=i)
    assert grads
    for slot, (j, p) in grads.items():
        assert p.shape == j.shape and p.dtype == j.dtype, slot
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL, err_msg=slot)


def test_top_k_and_accuracy_match_jax():
    r = _rng(3)
    x = _f32(r, 16, 10)
    label = r.integers(0, 10, (16, 1)).astype(np.int64)
    top = _run_both("top_k", {"X": x}, ["Out", "Indices"], {"k": 3})
    for slot, (j, p) in top.items():
        assert p.shape == j.shape, slot
        np.testing.assert_array_equal(p, j, err_msg=slot)
    idx = top["Indices"][1]
    label[:5, 0] = idx[:5, 1]          # some labels among the top 3
    acc = _run_both("accuracy", {"Out": top["Out"][1], "Indices": idx,
                                 "Label": label},
                    ["Accuracy", "Correct", "Total"], {})
    for slot, (j, p) in acc.items():
        assert p.shape == j.shape and p.dtype == j.dtype, slot
        np.testing.assert_array_equal(p, j, err_msg=slot)
    assert acc["Total"][1] == 16 and acc["Correct"][1] >= 5


def test_uniform_random_matches_jax_in_distribution():
    attrs = {"shape": [64, 64], "min": -0.5, "max": 1.5, "seed": 3,
             "dtype": 9, "__op_uid__": 2}
    n = 64 * 64
    for draw in _run_both("uniform_random", {}, ["Out"], attrs)["Out"]:
        assert draw.shape == (64, 64) and draw.dtype == np.float32
        assert draw.min() >= -0.5 and draw.max() < 1.5
        # mean 0.5, std 2/sqrt(12): within five standard errors
        assert abs(draw.mean() - 0.5) < 5 * (2 / 12 ** 0.5) / n ** 0.5


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 129, 513, 25000])
def test_sgd_op_matches_jax_lowered_sgd(n):
    r = _rng(n)
    ins = {"Param": _f32(r, n), "Grad": _f32(r, n),
           "LearningRate": np.array([LR], np.float32)}
    (j, p), = _run_both("sgd", ins, ["ParamOut"], {}).values()
    assert p.dtype == np.float32 and p.shape == j.shape
    assert _ulps(p, j).max() == 0
    # against the JAX Pallas kernel in interpret mode: XLA on the CPU
    # contracts its p - lr*g into one fused multiply-add (it equals the
    # once-rounded result exactly), while the lowered sgd, the port's
    # plain version and its CUDA kernel round lr*g first. The two then
    # differ by the rounding of lr*g and of the result: at most one
    # spacing of each (many ulp of the result where p and lr*g nearly
    # cancel).
    p64, g64 = (ins[s].astype(np.float64) for s in ("Param", "Grad"))
    lr = np.float32(LR)
    want = np.asarray(jfo.fused_sgd(jnp.asarray(ins["Param"]),
                                    jnp.asarray(ins["Grad"]),
                                    jnp.asarray(lr)))
    assert np.array_equal(want, (p64 - np.float64(lr) * g64).astype(
        np.float32))
    got = pfo.sgd_plain(torch.from_numpy(ins["Param"]),
                        torch.from_numpy(ins["Grad"]),
                        torch.tensor(lr)).numpy()
    assert np.array_equal(got, p)
    step = np.abs(lr * ins["Grad"])
    assert np.all(np.abs(got - want) <= np.spacing(step) +
                  np.spacing(np.abs(want)))


def test_fused_sgd_on_cpu_runs_the_plain_version():
    r = _rng(1)
    p, g = torch.from_numpy(_f32(r, 300)), torch.from_numpy(_f32(r, 300))
    lr = torch.tensor([LR])
    kreg.reset_counts()
    out = pfo.fused_sgd(p, g, lr, weight_decay=0.01)
    assert kreg.launches()["fused_sgd"] == 0
    assert torch.equal(out, p - lr[0] * (g + 0.01 * p))
    assert torch.equal(pfo.fused_sgd(p, g, lr), p - lr[0] * g)


# ---------------------------------------------------------------------------
# the LeNet program and 3 steps
# ---------------------------------------------------------------------------

def _build(fl, mod):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, acc, feeds = mod.lenet_train()
        test_prog = main.clone(for_test=True)
        fl.optimizer.SGD(learning_rate=LR).minimize(cost)
    return main, startup, test_prog, cost, acc


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def test_lenet_program_matches_jax():
    jmain, jstartup, jtest, _, _ = _build(fluid, jax_lenet)
    pmain, pstartup, ptest, _, _ = _build(pt, pt_lenet)
    types = _types(pmain)
    assert types == _types(jmain) and len(types) == 35
    assert [types.count(t) for t in ("fill_constant", "sgd")] == [1, 6]
    assert sum(t.endswith("_grad") for t in types) == 13
    assert _types(pstartup) == _types(jstartup)
    assert "uniform_random" in _types(pstartup)     # the fc's Xavier
    for j, p in zip(jmain.global_block().ops, pmain.global_block().ops):
        assert p._inputs == j._inputs and p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type
    # the test clone: the forward ops only, with the parameters kept
    assert _types(ptest) == _types(jtest) and len(_types(ptest)) == 15
    assert [p.name for p in ptest.all_parameters()] == \
        [p.name for p in pmain.all_parameters()]
    assert list(ptest.global_block().vars) == list(jtest.global_block().vars)


def test_clone_for_test_sets_is_test():
    for fl in (fluid, pt):
        fl.framework.unique_name.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", [8], dtype="float32")
            fl.layers.dropout(fl.layers.fc(x, 4), 0.5)
        test = main.clone(for_test=True)
        drop = [op for op in test.global_block().ops
                if op.type == "dropout"]
        assert [op.attr("is_test") for op in drop] == [True]
        assert not [op for op in main.global_block().ops
                    if op.type == "dropout"][0].attr("is_test")


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.rand(B, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (B, 1)).astype(np.int64)}


def test_three_sgd_steps_match_jax():
    jmain, jstartup, _, jcost, jacc = _build(fluid, jax_lenet)
    pmain, pstartup, _, pcost, pacc = _build(pt, pt_lenet)
    jscope, pscope = JaxScope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None]
    assert len(names) == 7             # 6 parameters and the rate
    load_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n).get_tensor())
                 for n in names}, pt.CPUPlace())
    feed = _batch()
    kreg.reset_counts()
    for _ in range(STEPS):
        jl, ja = jexe.run(jmain, feed=feed, fetch_list=[jcost, jacc],
                          scope=jscope)
        pl, pa = pexe.run(pmain, feed=feed, fetch_list=[pcost, pacc],
                          scope=pscope)
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(pa, np.asarray(ja))
    assert not any(kreg.launches().values())
    for n in names:
        got, want = (np.asarray(s.find_var(n).get_tensor())
                     for s in (pscope, jscope))
        assert got.dtype == want.dtype == np.float32, n
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# registry gates of the optimizer kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Arm the CPU routing hook and count the parameters the registry
    hands the two optimizer kernels' entry points: one a call of `run`,
    the list's length a call of `run_many` (the engine's grouped sgd
    ops)."""
    monkeypatch.setattr(kreg, "_ROUTE_ON_CPU", True)
    monkeypatch.delenv("PT_KERNEL_DENY", raising=False)
    monkeypatch.delenv("PT_KERNEL_MIN_NUMEL", raising=False)
    calls = {"fused_adam": 0, "fused_sgd": 0}
    for name in calls:
        kern = kreg.get(name)

        def spy(*a, _run=kern.run, _name=name, **kw):
            calls[_name] += 1
            return _run(*a, **kw)
        monkeypatch.setattr(kern, "run", spy)
        if kern.run_many is not None:
            def spy_many(ps, *a, _run=kern.run_many, _name=name, **kw):
                calls[_name] += len(ps)
                return _run(ps, *a, **kw)
            monkeypatch.setattr(kern, "run_many", spy_many)
    return calls


def _adam_inputs(n):
    r = _rng(n)
    return {"Param": _f32(r, n), "Grad": _f32(r, n),
            "Moment1": 0.1 * _f32(r, n),
            "Moment2": np.abs(0.01 * _f32(r, n)),
            "LearningRate": np.array([2e-4], np.float32),
            "Beta1Pow": np.array([0.9 ** 3], np.float32),
            "Beta2Pow": np.array([0.999 ** 3], np.float32)}


def _run_port(op_type, ins, outs, attrs):
    op = _Op(op_type, ins, outs, attrs)
    env = {s.lower(): torch.from_numpy(a.copy()) for s, a in ins.items()}
    PT_OPS.get(op_type).lowering(PtContext(op, env, torch.device("cpu")))
    return {s: env[op.output(s)[0]].numpy() for s in outs}


_ADAM = ("adam", ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                  "Beta2PowOut"], {"beta1": 0.9, "beta2": 0.999,
                                   "epsilon": 1e-8})


def _sgd_inputs(n):
    r = _rng(n)
    return {"Param": _f32(r, n), "Grad": _f32(r, n),
            "LearningRate": np.array([LR], np.float32)}


_SGD = ("sgd", ["ParamOut"], {})


@pytest.mark.parametrize("kernel,make,spec", [
    ("fused_adam", _adam_inputs, _ADAM), ("fused_sgd", _sgd_inputs, _SGD)],
    ids=["adam", "sgd"])
def test_optimizer_kernels_honour_the_registry(spies, monkeypatch, kernel,
                                               make, spec):
    op_type, outs, attrs = spec
    n = 33580                           # LeNet's parameters, all told
    ins = make(n)
    lowered = _run_port(op_type, ins, outs, attrs)       # floor 65536
    assert spies[kernel] == 0
    assert kreg.dispatch_stats()["per_kernel"] == {kernel: {"lowered": 1}}
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    routed = _run_port(op_type, ins, outs, attrs)
    assert spies[kernel] == 1
    monkeypatch.setenv("PT_KERNEL_DENY", f"other,{kernel}")
    denied = _run_port(op_type, ins, outs, attrs)
    assert spies[kernel] == 1
    monkeypatch.delenv("PT_KERNEL_DENY")
    set_flags({"FLAGS_use_custom_kernels": False})
    off = _run_port(op_type, ins, outs, attrs)
    assert spies[kernel] == 1
    assert kreg.dispatch_stats()["per_kernel"] == {
        kernel: {"lowered": 1, "custom": 1, "denied": 1}}
    for s in outs:     # the same values whichever way the op went
        for other in (routed, denied, off):
            assert np.array_equal(other[s], lowered[s]), s
    # at the floor exactly the kernel is eligible, one below it is not
    kern = kreg.get(kernel)
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "65536")
    assert kern.eligible(kreg.Signature(op_type, ("float32",) * 2,
                                        ((65536,), (65536,)), "cpu"))
    assert not kern.eligible(kreg.Signature(op_type, ("float32",) * 2,
                                            ((65535,), (65535,)), "cpu"))
    assert not kern.eligible(kreg.Signature(op_type, ("bfloat16",) * 2,
                                            ((65536,), (65536,)), "cpu"))


def test_optimizer_registry_matches_jax_eligibility(monkeypatch):
    """The port's entries decide as the JAX package's on the same
    signatures."""
    from paddle_tpu.kernels import registry as jkreg
    for floor in ("65536", "1"):
        monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", floor)
        for name in ("fused_adam", "fused_sgd"):
            for shape, dt in (((200, 500), "float32"),
                              ((256, 256), "float32"),
                              ((256, 256), "bfloat16")):
                sig = kreg.Signature("x", (dt, dt), (shape, shape), "cpu")
                jsig = jkreg.Signature(op_type="x", shapes=(shape, shape),
                                       dtypes=(dt, dt))
                assert kreg.get(name).eligible(sig) == \
                    jkreg.get(name).eligible(jsig), (name, shape, dt)


@pytest.mark.parametrize("floor,routed", [("65536", 0), ("1", 6)])
def test_lenet_step_routes_sgd_by_the_floor(spies, monkeypatch, floor,
                                            routed):
    """At the default floor every LeNet parameter (at most 25000
    elements) takes the plain update; at 1 each of the 6 routes."""
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", floor)
    pt.framework.unique_name.reset()
    main, startup, _, cost, _ = _build(pt, pt_lenet)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    loss, = exe.run(main, feed=_batch(), fetch_list=[cost], scope=scope)
    assert np.isfinite(loss)
    assert spies["fused_sgd"] == routed
    stats = kreg.dispatch_stats()["per_kernel"]["fused_sgd"]
    assert stats == ({"custom": 6} if routed else {"lowered": 6})
