"""The learning-rate schedules (layers/learning_rate_scheduler.py) in the
port against the JAX package, and the rate they write as the optimizers
read it.

* Each of the eight schedules, built in a program of both packages and
  run 20 times: the rate of every run within RTOL of the JAX package's
  (its step counter advancing once a run, from 1).
* Two schedules in one program share one counter.
* Adam under noam_decay, SGD under piecewise_decay and Momentum under
  exponential_decay on a small fc net: the engine's cached runs (the
  second captures the block; on the CPU the later runs replay it on the
  static tensors) equal eager runs step for step, and equal the JAX
  package's losses; the adam / sgd group lowerings and the momentum
  lowering read the new rate each step (the losses would repeat the
  first step's rate otherwise, and the check against the schedule's
  values catches it).
* autoincreased_step_counter: begin, begin + step, ... one a run,
  captured runs included.

Tolerance: RTOL = 1e-6 relative on the rates (float32 ops in both; the
exponential schedules go through exp and pow, where the two libm may
round apart by an ulp); losses within LOSS_RTOL = 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
LOSS_RTOL = 1e-5
STEPS = 20
CPU = pt.CPUPlace()

SCHEDULES = {
    "noam_decay": lambda L: L.noam_decay(512, 4),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_decay_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_decay_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "inverse_time_decay_staircase": lambda L: L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 12, 0.001, 2.0),
    "polynomial_decay_cycle": lambda L: L.polynomial_decay(
        0.1, 6, 0.001, 1.5, cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([3, 8, 15],
                                                   [0.1, 0.05, 0.01,
                                                    0.001]),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 10),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 6, 0.0, 0.1),
    "linear_lr_warmup_over_noam": lambda L: L.linear_lr_warmup(
        L.noam_decay(64, 10), 5, 0.001, 0.01),
}


def _rates(fl, build, scope, exe, cached=True):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        lr = build(fl.layers)
    exe.run(startup, scope=scope)
    kw = {} if fl is fluid else {"use_program_cache": cached}
    return [float(np.asarray(exe.run(main, fetch_list=[lr], scope=scope,
                                     **kw)[0]).reshape(-1)[0])
            for _ in range(STEPS)]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_over_20_steps(name):
    want = _rates(fluid, SCHEDULES[name], JaxScope(),
                  fluid.Executor(fluid.CPUPlace()))
    got = _rates(pt, SCHEDULES[name], pt.Scope(), pt.Executor(CPU))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert len(set(want)) > 1


def test_schedules_share_one_counter():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = pt.layers.noam_decay(64, 3)
        b = pt.layers.cosine_decay(0.1, 1, 10)
    incs = [op for op in main.global_block().ops if op.type == "increment"]
    assert len(incs) == 1
    scope, exe = pt.Scope(), pt.Executor(CPU)
    exe.run(startup, scope=scope)
    for step in range(1, 4):
        ra, rb = exe.run(main, fetch_list=[a, b], scope=scope)
        np.testing.assert_allclose(
            [ra[0], rb[0]], [64 ** -0.5 * min(step ** -0.5, step * 3 ** -1.5),
                             0.05 * (np.cos(np.pi * step / 10) + 1)],
            rtol=1e-6)


def _net(fl, opt_name):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    L = fl.layers
    with fl.program_guard(main, startup):
        x = L.data(name="x", shape=[6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, 8, act="tanh", param_attr=fl.ParamAttr(name="w0"),
                 bias_attr=fl.ParamAttr(name="b0"))
        pred = L.fc(h, 1, param_attr=fl.ParamAttr(name="w1"),
                    bias_attr=fl.ParamAttr(name="b1"))
        cost = L.mean(L.square_error_cost(pred, y))
        if opt_name == "adam":
            lr = L.noam_decay(16, 3)
            opt = fl.optimizer.AdamOptimizer(learning_rate=lr)
        elif opt_name == "sgd":
            lr = L.piecewise_decay([2, 4], [0.3, 0.1, 0.02])
            opt = fl.optimizer.SGD(learning_rate=lr)
        else:
            lr = L.exponential_decay(0.2, 2, 0.5)
            opt = fl.optimizer.MomentumOptimizer(learning_rate=lr,
                                                 momentum=0.9)
        opt.minimize(cost)
    return main, startup, cost, lr


def _feed():
    r = np.random.default_rng(3)
    return {"x": r.standard_normal((8, 6)).astype(np.float32),
            "y": r.standard_normal((8, 1)).astype(np.float32)}


_PARAMS = ("w0", "b0", "w1", "b1")


@pytest.mark.parametrize("opt_name", ["adam", "sgd", "momentum"])
def test_optimizers_read_the_new_rate_each_step(opt_name):
    jmain, jstart, jcost, jlr = _net(fluid, opt_name)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {n: np.asarray(jscope.find_var(n).get_tensor())
            for n in _PARAMS}
    want = [jexe.run(jmain, feed=_feed(), fetch_list=[jcost, jlr],
                     scope=jscope) for _ in range(6)]
    main, start, cost, lr = _net(pt, opt_name)
    runs = {}
    for cached in (True, False):
        scope, exe = pt.Scope(), pt.Executor(CPU)
        exe.run(start, scope=scope)
        pt.io.load_params_from_numpy(scope, init, CPU)
        runs[cached] = [exe.run(main, feed=_feed(), fetch_list=[cost, lr],
                                scope=scope, use_program_cache=cached)
                        for _ in range(6)]
        if cached:
            c = exe._engine.counters
            assert (c["captures"], c["replays"]) == (1, 5)
    for got_c, got_e, (jc, jl) in zip(runs[True], runs[False], want):
        assert [float(v.reshape(-1)[0]) for v in got_c] == \
            [float(v.reshape(-1)[0]) for v in got_e]
        np.testing.assert_allclose(float(got_c[1].reshape(-1)[0]),
                                   float(np.asarray(jl).reshape(-1)[0]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(got_c[0].reshape(-1)[0]),
                                   float(np.asarray(jc).reshape(-1)[0]),
                                   rtol=LOSS_RTOL)
    assert len({float(r[1].reshape(-1)[0]) for r in runs[True]}) > 1


def test_step_counter_advances_every_run_captured_too():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        c = pt.layers.autoincreased_step_counter(begin=5, step=2)
        again = pt.layers.autoincreased_step_counter()
    assert again.name == c.name == "@STEP_COUNTER@"
    scope, exe = pt.Scope(), pt.Executor(CPU)
    exe.run(startup, scope=scope)
    got = [int(exe.run(main, fetch_list=[c], scope=scope)[0][0])
           for _ in range(5)]
    # begin - step = 3, then two increments a run: +2, then the second
    # builder's +1
    assert got == [6, 9, 12, 15, 18]
    assert exe._engine.counters["replays"] == 4
