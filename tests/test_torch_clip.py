"""Gradient clipping in the port against the JAX package.

* Each clip of clip.py (GradientClipByValue, GradientClipByNorm,
  GradientClipByGlobalNorm) set by set_gradient_clip, and a
  per-parameter ParamAttr(gradient_clip=...), builds the JAX package's
  ops (the same ProgramDesc bytes), and 2 SGD steps from the JAX
  package's initial parameters equal its steps within TOL = 1e-5
  relative and absolute. The bounds are set so that each clip binds.
* The dygraph clips of dygraph_grad_clip.py, passed to
  minimize(grad_clip=...) (the reference applies them there; the JAX
  package drops the argument), equal a JAX step whose gradients were
  clipped by calling the JAX dygraph_grad_clip.py by hand.
* minimize(grad_clip=...) in graph mode raises (the reference applies
  it in dygraph mode only), before it appends a gradient op.

The JAX set_gradient_clip is a module global: a fixture clears it, and
the port's, after every test.
"""
import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import load_params_from_numpy

from test_torch_book import _widen_desc
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_clips():
    yield
    fluid.clip.set_gradient_clip(None)
    pt.clip.set_gradient_clip(None)


def _clip(fl, kind):
    return {"value": lambda: fl.clip.GradientClipByValue(0.02),
            "norm": lambda: fl.clip.GradientClipByNorm(0.05),
            "global_norm": lambda: fl.clip.GradientClipByGlobalNorm(0.05),
            "loose_global_norm":
                lambda: fl.clip.GradientClipByGlobalNorm(100.0)}[kind]()


def _program(fl, kind, how="set"):
    fl.framework.unique_name.reset()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        x = fl.layers.data("x", [4], dtype="float32")
        y = fl.layers.data("y", [1], dtype="float32")
        attr = fl.ParamAttr(name="w1", gradient_clip=_clip(fl, kind)) \
            if how == "param" else fl.ParamAttr(name="w1")
        h = fl.layers.fc(x, 6, param_attr=attr, act="tanh")
        pred = fl.layers.fc(h, 1, param_attr=fl.ParamAttr(name="w2"))
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        if how == "set":
            fl.clip.set_gradient_clip(_clip(fl, kind))
        fl.optimizer.SGD(0.1).minimize(loss)
    return main, start, loss


def _train(fl, main, start, loss, params=None, steps=2):
    r = np.random.default_rng(4)
    scope = pt.Scope() if fl is pt else fluid.core.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(start, scope=scope)
    if params is not None:
        load_params_from_numpy(scope, params, pt.CPUPlace())
    names = [p.name for p in main.all_parameters()]
    init = {n: np.array(scope.find_var(n).get_tensor()) for n in names}
    losses = []
    for _ in range(steps):
        feed = {"x": r.standard_normal((8, 4)).astype(np.float32) * 3,
                "y": r.standard_normal((8, 1)).astype(np.float32) * 3}
        losses.append(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=scope)[0]))
    return init, losses, {n: np.array(scope.find_var(n).get_tensor())
                          for n in names}


@pytest.mark.parametrize("kind,how", [
    ("value", "set"), ("norm", "set"), ("global_norm", "set"),
    ("loose_global_norm", "set"), ("value", "param"), ("norm", "param"),
    ("global_norm", "param")])
def test_clip_program_trains_as_jax(kind, how):
    jm, js, jl = _program(fluid, kind, how)
    pm, ps, pl = _program(pt, kind, how)
    mine = pm.serialize_to_string()
    assert _widen_desc(jm.serialize_to_string(), mine, ("",)) == mine
    types = [o.type for o in pm.global_block().ops]
    want = {"value": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm",
            "loose_global_norm": "squared_l2_norm"}[kind]
    assert want in types
    init, jloss, jparams = _train(fluid, jm, js, jl)
    _, ploss, pparams = _train(pt, pm, ps, pl, params=init)
    for a, b in zip(ploss, jloss):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for n in jparams:
        np.testing.assert_allclose(pparams[n], jparams[n], rtol=TOL,
                                   atol=TOL, err_msg=n)
    # the clip binds (or, for the loose bound, does not): against the
    # unclipped step from the same parameters
    pt.clip.set_gradient_clip(None)
    um, us, ul = _program(pt, "value", "none")
    _, _, free = _train(pt, um, us, ul, params=init)
    moved = max(np.abs(free[n] - pparams[n]).max() for n in free)
    assert (moved < 1e-7) if kind == "loose_global_norm" else moved > 1e-4


def test_minimize_grad_clip_in_graph_mode():
    """In a program any clip passed to minimize is refused, never
    dropped, and the program is left as it was."""
    for clip in (pt.clip.GradientClipByGlobalNorm(0.05),
                 pt.dygraph_grad_clip.GradClipByNorm(1.0)):
        pt.framework.unique_name.reset()
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            x = pt.layers.data("x", [4], dtype="float32")
            loss = pt.layers.mean(pt.layers.fc(x, 2))
            n = len(main.global_block().ops)
            with pytest.raises(ValueError, match="dygraph mode only"):
                pt.optimizer.SGD(0.1).minimize(loss, grad_clip=clip)
        assert len(main.global_block().ops) == n


def _dygraph_step(fl, clip, init=None):
    r = np.random.default_rng(2)
    x = r.standard_normal((6, 4)).astype(np.float32) * 3
    with fl.dygraph.guard(fl.CPUPlace()):
        np.random.seed(0)
        net = fl.dygraph.nn.FC("fc", 3)
        out = net(fl.dygraph.to_variable(x))
        params = list(net.parameters())
        if init is not None:
            for p, a in zip(params, init):
                p.set_value(a)
            out = net(fl.dygraph.to_variable(x))
        before = [p.numpy() for p in params]
        loss = fl.layers.mean(fl.layers.square(out))
        loss.backward()
        opt = fl.optimizer.SGD(0.5)
        if fl is pt:
            opt.minimize(loss, grad_clip=clip)
        else:
            clip(params)            # the JAX minimize drops grad_clip
            opt.minimize(loss)
        return before, [p.numpy() for p in params]


@pytest.mark.parametrize("kind", ["GradClipByValue", "GradClipByNorm",
                                  "GradClipByGlobalNorm"])
def test_dygraph_clip_in_minimize_matches_jax(kind):
    arg = {"GradClipByValue": 0.01, "GradClipByNorm": 0.05,
           "GradClipByGlobalNorm": 0.05}[kind]
    init, jafter = _dygraph_step(
        fluid, getattr(fluid.dygraph_grad_clip, kind)(arg))
    before, pafter = _dygraph_step(
        pt, getattr(pt.dygraph_grad_clip, kind)(arg), init)
    for a, b in zip(before, init):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pafter, jafter):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # the clip bound: an unclipped step moves further
    _, free = _dygraph_step(pt, None, init)
    assert max(np.abs(f - b).max() for f, b in zip(free, before)) > \
        2 * max(np.abs(a - b).max() for a, b in zip(pafter, before))
